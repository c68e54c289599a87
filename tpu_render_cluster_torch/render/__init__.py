"""The port's render engine: sphere scenes, whole frames, one CUDA megakernel.

- ``scene.py`` / ``camera.py``: scene and camera tensors per frame;
- ``rng.py``: the reference's threefry key schedule, bit for bit;
- ``integrator.py``: primary rays, the trace, averaging and tonemapping;
- ``kernels.py``: the path-trace megakernel's wrapper and plain version;
- ``fp32.py``: float32 arithmetic rounded as the reference's compiler does;
- ``csrc/`` + ``_build.py``: the CUDA source and its nvcc build;
- ``image_io.py`` / ``cli.py``: output files and the standalone CLI.

Nothing is imported eagerly: importing a submodule builds no kernel and
touches no GPU.
"""
