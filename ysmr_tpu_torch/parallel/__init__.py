"""Multi-device modes of the port: video-batch data parallelism and the
row-sharded dense assignment over a device mesh (``sharding.py``), and
stage 1 for many videos at once (``multi_video.py``)."""
