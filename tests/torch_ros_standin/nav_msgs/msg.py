"""``nav_msgs.msg``: the stand-in's classes of the bag's flavour."""
import ros_standin

globals().update(ros_standin.package("nav_msgs"))
