"""Host-side statistics of the node's diagnostics."""
