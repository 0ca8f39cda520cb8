"""Stand-in ``sensor_msgs`` (see ``ros_standin.py``)."""
