"""PyTorch / CUDA port of the ``repro`` package, for NVIDIA Hopper.

It grows beside ``repro`` (the JAX reference) slice by slice and imports
nothing from it.  Module names mirror ``repro``'s: ``configs``, ``kernels``,
``models``, ``serve``, ``launch``.  The serving path of the dense family
runs through hand-written kernels on the card (``kernels/``).
"""
