"""Per-sample geometry: undistortion, RANSAC homography, decomposition, getRT."""
