"""Device ops: preprocessing, phase-correlation math and the hand-written kernels."""
