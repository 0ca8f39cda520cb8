"""Stand-in ``rclpy.node.Node``: publishers, subscriptions and a logger on
the stand-in graph."""

import sys
import time

import ros_standin
from rclpy.qos import QoSProfile


class _Logger:
    """``RcutilsLogger``: every level to standard error."""

    def __init__(self, name):
        self.name = name

    def _log(self, level, message):
        print(f"[{level}] [{time.time():.6f}] [{self.name}]: {message}", file=sys.stderr, flush=True)
        return True

    def info(self, message, **kwargs):
        return self._log("INFO", message)

    def warning(self, message, **kwargs):
        return self._log("WARN", message)

    warn = warning

    def error(self, message, **kwargs):
        return self._log("ERROR", message)


def _qos(qos_profile):
    if not isinstance(qos_profile, (int, QoSProfile)) or isinstance(qos_profile, bool):
        raise TypeError(f"qos_profile must be a QoSProfile or a history depth, got {qos_profile!r}")


class Node:
    def __init__(self, node_name, *, context=None, cli_args=None, namespace=None, use_global_arguments=True,
                 enable_rosout=True, start_parameter_services=True, parameter_overrides=None,
                 allow_undeclared_parameters=False, automatically_declare_parameters_from_overrides=False):
        self._name, self._ns = node_name, namespace or "/"
        self._graph = ros_standin.graph(True)

    def get_fully_qualified_name(self) -> str:
        return self._ns.rstrip("/") + "/" + self._name

    def get_logger(self):
        return _Logger(self.get_fully_qualified_name())

    def create_publisher(self, msg_type, topic, qos_profile, *, callback_group=None, event_callbacks=None,
                         qos_overriding_options=None, publisher_class=None):
        _qos(qos_profile)
        pub = ros_standin.Endpoint(self._graph, topic, msg_type)
        self._graph.pubs.append(pub)
        return pub

    def create_subscription(self, msg_type, topic, callback, qos_profile, *, callback_group=None,
                            event_callbacks=None, qos_overriding_options=None, raw=False):
        _qos(qos_profile)
        sub = ros_standin.Endpoint(self._graph, topic, msg_type, callback)
        self._graph.subs.append(sub)
        return sub
