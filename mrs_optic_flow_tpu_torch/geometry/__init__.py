"""Geometry: undistortion, RANSAC homography, decomposition, getRT and
get2DT, per pair and batched (:mod:`.batched`)."""
