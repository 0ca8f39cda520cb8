# ROS2 launch of the PyTorch port — the rclpy twin of
# launch/optic_flow_tpu_torch.launch and the port's copy of
# launch/optic_flow_tpu.launch.py: same namespace convention, frame-id
# arguments and topic remap surface, driving the port's executable
# (scripts/optic_flow_tpu_torch_node --ros2) on the CUDA card unless
# device:=cpu.
#
#   ros2 launch mrs_optic_flow_tpu optic_flow_tpu_torch.launch.py \
#       uav_name:=uav1 config:=/path/to/default.yaml device:=cuda

from launch import LaunchDescription
from launch.actions import DeclareLaunchArgument
from launch.substitutions import EnvironmentVariable, LaunchConfiguration
from launch_ros.actions import Node


def generate_launch_description():
    uav_name = LaunchConfiguration("uav_name")
    config = LaunchConfiguration("config")
    camera_frame = LaunchConfiguration("camera_frame")
    uav_frame = LaunchConfiguration("uav_frame")
    uav_untilted_frame = LaunchConfiguration("uav_untilted_frame")
    device = LaunchConfiguration("device")

    return LaunchDescription([
        DeclareLaunchArgument(
            "uav_name", default_value=EnvironmentVariable("UAV_NAME",
                                                          default_value="uav1")),
        DeclareLaunchArgument("config", default_value=""),
        DeclareLaunchArgument(
            "camera_frame",
            default_value=[uav_name, "/bluefox_optflow_optical"]),
        DeclareLaunchArgument("uav_frame", default_value=[uav_name, "/fcu"]),
        DeclareLaunchArgument(
            "uav_untilted_frame", default_value=[uav_name, "/fcu_untilted"]),
        # the torch device: cuda (the card) or cpu
        DeclareLaunchArgument("device", default_value="cuda"),
        Node(
            package="mrs_optic_flow_tpu",
            executable="optic_flow_tpu_torch_node",
            name="optic_flow",
            namespace=uav_name,
            output="screen",
            arguments=[
                "--ros2",
                "--camera-frame", camera_frame,
                "--uav-frame", uav_frame,
                "--uav-untilted-frame", uav_untilted_frame,
                "--config", config,
                "--device", device,
            ],
            remappings=[
                # the reference's remaps (launch/optic_flow.launch:45-58)
                # under ROS2's ~/ private-topic spelling
                ("~/active_tracker_in", "control_manager/diagnostics"),
                ("~/odometry_in", "odometry/orientation"),
                ("~/camera_in", "bluefox_optflow/image_raw"),
                ("~/camera_info_in", "bluefox_optflow/camera_info"),
                ("~/uav_height_in", "odometry/height"),
                ("~/imu_in", "mavros/imu/data"),
                ("~/velocity_out", "~/velocity"),
                ("~/velocity_out_longrange", "~/velocity_longrange"),
                ("~/velocity_stddev_out", "~/velocity_stddev"),
                ("~/allsac_chosen_out", "~/allsac_chosen"),
            ],
        ),
    ])
