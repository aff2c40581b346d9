"""Device kernels of the port and the host DP layer around them.

``banded_swipe`` is the host DP (numpy oracle and native C++ batches);
``swipe_device`` holds the banded-SWIPE kernel's wrapper, its plain PyTorch
version and the ``DeviceDP`` batcher, and the full-matrix sweeps
``FullSweep`` and ``SwipeSweep``; ``swipe3_device`` the 3-frame kernel;
``swipe_uniform_device`` the uniform-band kernel over one query's jobs and
``swipe_uniform`` its plain tensor-op twin; ``stage2_device`` the stage-2
seeding filter and ``stage12`` the stage-1 one-hot product; ``_cuda`` builds
and binds the CUDA sources under ``diamond_tpu_torch/csrc``.
"""
