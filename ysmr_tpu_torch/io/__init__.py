"""Host-side IO: video decode with background prefetch and host thresholding."""
