"""Batched vision operators: small linear algebra, pyramidal LK (with its
hand-written CUDA level kernel), corner detection, homography,
triangulation and PnP.  Everything is fixed-shape masked tensor code."""
