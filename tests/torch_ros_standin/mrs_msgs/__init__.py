"""Stand-in ``mrs_msgs``; with ``ROS_STANDIN_NO_MRS_MSGS=1`` it is not
installed (see ``ros_standin.py``)."""
import os

import ros_standin

if os.environ.get(ros_standin.NO_MRS_ENV) == "1":
    raise ModuleNotFoundError("No module named 'mrs_msgs'", name="mrs_msgs")
