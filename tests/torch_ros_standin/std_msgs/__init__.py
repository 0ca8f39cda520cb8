"""Stand-in ``std_msgs`` (see ``ros_standin.py``)."""
