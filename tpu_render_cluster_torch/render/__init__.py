"""The port's render engine: whole frames through two CUDA megakernels.

- ``scene.py`` / ``camera.py``: scene and camera tensors per frame;
- ``mesh.py``: triangle meshes, their threaded BVH and rigid instances;
- ``rng.py``: the reference's threefry key schedule, bit for bit;
- ``integrator.py``: primary rays, the trace, averaging and tonemapping;
- ``kernels.py``: the sphere and mesh megakernels' wrappers and plain
  versions;
- ``fp32.py``: float32 arithmetic rounded as the reference's compiler does;
- ``csrc/`` + ``_build.py``: the CUDA sources and their nvcc build;
- ``image_io.py`` / ``cli.py``: output files and the standalone CLI.

Nothing is imported eagerly: importing a submodule builds no kernel and
touches no GPU.
"""
