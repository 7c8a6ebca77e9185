"""Hand-written CUDA kernels of the port (``repro_torch/kernels`` ↔
``repro/kernels``).  Each kernel sits beside its plain-torch version; sources
under ``<kernel>/csrc/`` are built by ``_build.py`` at first use."""
