"""Device kernels of the port and the host DP layer around them.

``banded_swipe`` is the host DP (numpy oracle and native C++ batches);
``swipe_device`` holds the banded-SWIPE kernel's wrapper, its plain PyTorch
version and the ``DeviceDP`` batcher; ``_cuda`` builds and binds the CUDA
sources under ``diamond_tpu_torch/csrc``.
"""
