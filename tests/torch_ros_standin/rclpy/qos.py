"""Stand-in ``rclpy.qos``: ``QoSProfile`` and the sensor-data profile."""


class QoSProfile:
    def __init__(self, **kwargs):
        if "history" not in kwargs and "depth" not in kwargs:
            raise TypeError("QoSProfile needs a history or a depth")
        self.__dict__.update(kwargs)


#: best effort, keep last 5 (rmw_qos_profile_sensor_data)
qos_profile_sensor_data = QoSProfile(depth=5, reliability="best_effort")
