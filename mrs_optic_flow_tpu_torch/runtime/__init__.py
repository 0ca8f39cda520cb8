"""Node runtime: messages, profiler and the short-range OpticFlowNode."""
