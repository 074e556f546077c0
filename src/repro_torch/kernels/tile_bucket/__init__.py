"""The rung tiling's counting sort: ``ops.py`` the wrapper, ``ref.py`` the
slot rule in plain PyTorch, ``csrc/tile_bucket.cu`` the count, scatter and
chunk-plan kernels.  The plain version of the whole tiling is
``graph/partition.py::bucket_edges_by_sort``."""
