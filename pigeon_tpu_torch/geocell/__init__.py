"""Geographic work on the host: boundary polygons, the metadata augmentor,
and the offline geocell tooling (`pigeon_tpu/geocell/`'s counterparts):
the planar geometry engine, finite Voronoi cells, OPTICS, semantic and
naive geocells, point -> cell assignment and the prototype builder, with
the C++ geo kernels of `geokernels.py`."""
