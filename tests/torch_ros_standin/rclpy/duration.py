"""Stand-in ``rclpy.duration.Duration``: keyword-only seconds and nanoseconds."""


class Duration:
    def __init__(self, *, seconds=0, nanoseconds=0):
        self.nanoseconds = int(seconds * 1e9) + int(nanoseconds)
