"""PyTorch/CUDA port of the Pyramid index (``repro`` is the JAX reference).

Layout mirrors ``repro``: ``common``, ``core``, ``data``, ``build`` and
``kernels/<name>/{ref,ops}.py``. Entry points run on the CUDA device
unless the caller passes ``device="cpu"``; hand-written kernels live in
``csrc/`` (CUDA C++, one source a kernel, wrapped by the ``kernels``
packages) and are built on first use into ``_build/``.
"""
