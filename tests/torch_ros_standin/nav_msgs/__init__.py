"""Stand-in ``nav_msgs`` (see ``ros_standin.py``)."""
