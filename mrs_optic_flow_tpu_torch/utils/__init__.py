"""Host-side helpers: the node's numpy quaternion math and device selection."""
