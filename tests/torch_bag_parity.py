"""Helpers shared by the bag and bridge parity tests of the PyTorch port
(not a test module): seeded messages as either package's classes, each
encoder by name, the same writes through either package's writer, and the
comparison of two packages' decoded messages."""

import dataclasses

import numpy as np

DT = 0.05
TWIST_PARITY = 1e-3  # m/s, the port node against the JAX node (test_torch_node.py)
#: the bridges' parity flight: ``test_torch_node.py``'s stream and geometry
#: (frame 256 cut from 320x288 renders, 4x4 windows of 64 px, every window
#: an inlier).  At the default geometry on the bridge tests' 752x480 stream
#: one of the five twists differs by 3.7e-3 m/s between the nodes, and each
#: node's own twists move by up to 3.9e-3 m/s when +-0.02 of a grey level
#: of noise is added to the frames: that stream's geometry, not the port,
#: sets the difference there (both stay within 0.15 m/s of the truth).
PARITY_SCENE = dict(width=320, height_px=288, uav_height=2.0, seed=3)
PARITY_OVERRIDES = {"mrs_optic_flow": {"frame_size": 256, "sample_point_size": 64}}

#: the encoders every test holds byte for byte against the JAX package's
ENCODED = ["image_mono8", "image_bgr8", "image_float", "camera_info", "imu", "odometry",
           "float64_stamped"]


def rand_q(rng) -> np.ndarray:
    q = rng.standard_normal(4)
    return q / np.linalg.norm(q)


def assert_same_message(ours, theirs):
    """The port's message equals the JAX package's: the same class name and
    every field equal (arrays bit for bit)."""
    assert type(ours).__name__ == type(theirs).__name__
    fa = {f.name: getattr(ours, f.name) for f in dataclasses.fields(ours)}
    fb = {f.name: getattr(theirs, f.name) for f in dataclasses.fields(theirs)}
    assert fa.keys() == fb.keys()
    for k in fa:
        if isinstance(fa[k], np.ndarray):
            assert fa[k].dtype == fb[k].dtype, k
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
        else:
            assert fa[k] == fb[k], k


def messages(msgs) -> dict:
    """The encoders' inputs, seeded, as the classes of ``msgs`` (either
    package's ``runtime.msgs``); stamps that round near a whole second and a
    float image included."""
    rng = np.random.default_rng(3)
    gray = rng.integers(0, 256, (13, 7), dtype=np.uint8)
    bgr = rng.integers(0, 256, (5, 6, 3), dtype=np.uint8)
    quat = tuple(float(v) for v in rand_q(rng))
    return {
        "image_mono8": msgs.ImageMsg(stamp=104.123456789, data=gray),
        "image_bgr8": msgs.ImageMsg(stamp=104.9999999996, data=bgr),
        "image_float": msgs.ImageMsg(stamp=3.5, data=gray.astype(np.float32) + 0.4),
        "camera_info": msgs.CameraInfo(k=[400.0, 0, 376.5, 0, 410.0, 240.25, 0, 0, 1],
                                       d=[0.1, -0.05, 0.001, 0.002, 0.01], binning_x=2),
        "imu": msgs.Imu(stamp=99.9999, angular_velocity=(0.1, -0.2, 0.3), orientation=quat),
        "odometry": msgs.Odometry(stamp=101.05, orientation=quat, linear_velocity=(1.5, -0.5, 0.1),
                                  angular_velocity=(0.0, 0.0, 0.2)),
        "float64_stamped": msgs.Float64Stamped(stamp=7.000000001, value=3.75),
    }


def encode(mod, name, msg) -> bytes:
    """``name``'s message through ``mod``'s encoder (``rosbag`` or ``rosbag2``
    of either package)."""
    if name.startswith("image"):
        return mod.encode_image_msg(msg)
    if name == "camera_info":
        return mod.encode_camera_info_msg(msg, 98.75, shape=(480, 752))
    return getattr(mod, f"encode_{name}_msg")(msg)


def write_flight(mod, msgs, path, ros2: bool = False) -> str:
    """The same writes through ``mod``'s writer (``BagWriter``, or with
    ``ros2`` ``Bag2Writer`` and the ROS2 type names): every encoder's
    message on its own topic, three frames of three kinds of image."""
    m = messages(msgs)

    def typ(name):
        pkg, msg = name.split("/")
        return f"{pkg}/msg/{msg}" if ros2 else name

    with (mod.Bag2Writer if ros2 else mod.BagWriter)(str(path)) as bag:
        bag.write("/camera_info", typ("sensor_msgs/CameraInfo"), 98.75,
                  encode(mod, "camera_info", m["camera_info"]))
        for i in range(3):
            t = 100.0 + i * DT - 2e-10
            bag.write("/imu", typ("sensor_msgs/Imu"), t - 1e-4, encode(mod, "imu", m["imu"]))
            bag.write("/odometry", typ("nav_msgs/Odometry"), t - 1e-4,
                      encode(mod, "odometry", m["odometry"]))
            bag.write("/height", typ("mrs_msgs/Float64Stamped"), t - 1e-4,
                      encode(mod, "float64_stamped", m["float64_stamped"]))
            name = ("image_mono8", "image_bgr8", "image_float")[i]
            bag.write("/image_raw", typ("sensor_msgs/Image"), t, encode(mod, name, m[name]))
    return str(path)
