"""Stand-in ``geometry_msgs`` (see ``ros_standin.py``)."""
