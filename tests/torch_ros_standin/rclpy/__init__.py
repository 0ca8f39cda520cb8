"""Stand-in ``rclpy`` (humble): init/shutdown, nodes, ``spin`` and
``spin_once`` over the stand-in graph of ``ros_standin.py``."""

import sys

import ros_standin
from rclpy.node import Node


class NotInitializedException(Exception):
    pass


_context = {"ok": False, "args": None}


def _graph():
    return ros_standin.graph(True)


def init(*, args=None, context=None, domain_id=None, signal_handler_options=None):
    if _context["ok"]:
        raise RuntimeError("Context.init() must only be called once")
    _context["ok"], _context["args"] = True, list(sys.argv if args is None else args)
    _graph()


def shutdown(*, context=None, uninstall_handlers=None):
    if not _context["ok"]:
        raise RuntimeError("Context must be initialized before it can be shutdown")
    _context["ok"] = False


def _remaps() -> dict:
    """``-r from:=to`` pairs of the ``--ros-args`` sections of init's args."""
    out, args, inside = {}, _context["args"], False
    for i, a in enumerate(args):
        if a == "--ros-args":
            inside = True
        elif a == "--":
            inside = False
        elif inside and a in ("-r", "--remap") and i + 1 < len(args):
            src, _, dst = args[i + 1].partition(":=")
            out[src] = dst
    return out


def create_node(node_name, *, context=None, cli_args=None, namespace=None, use_global_arguments=True,
                enable_rosout=True, start_parameter_services=True, parameter_overrides=None,
                allow_undeclared_parameters=False, automatically_declare_parameters_from_overrides=False):
    if not _context["ok"]:
        raise NotInitializedException("cannot create node")
    remaps = _remaps()
    node = Node(remaps.get("__node", node_name), namespace=remaps.get("__ns", namespace))
    _graph().node_name = node.get_fully_qualified_name()
    return node


def _check(node):
    if not _context["ok"]:
        raise NotInitializedException("rclpy.init() has not been called")
    if not isinstance(node, Node):
        raise TypeError(f"spin takes an rclpy node, got {node!r}")


def spin_once(node, *, executor=None, timeout_sec=None):
    """Deliver the bag's first camera info once, then nothing."""
    _check(node)
    graph = _graph()
    if graph.camera_info_answered:
        return
    for sub in [s for s in graph.subs if s.name == "~/camera_info_in"]:
        graph.camera_info_answered = True
        graph.deliver(sub, graph.answer_camera_info(sub.name, sub.data_class))


def spin(node, executor=None):
    """Play the bag through the subscriptions, then return."""
    _check(node)
    _graph().play()
