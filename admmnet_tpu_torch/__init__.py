"""admmnet_tpu_torch: the PyTorch + CUDA port of admmnet_tpu for NVIDIA Hopper.

Same module layout and public names as the JAX package ``admmnet_tpu``,
which stays the reference the port is tested against:

- ``core``     -- configuration dataclasses and their conversion from JAX
- ``data``     -- the bundled anchor case and synthetic datasets
- ``ops``      -- atoms, lifted-matrix helpers, projections
- ``kernels``  -- hand-written CUDA kernels (``csrc/``), built with nvcc at
                  first launch and bound with ctypes, each with a plain
                  PyTorch version used for CPU tensors
- ``solver``   -- batched classical ANM-DUMV ADMM
- ``peaks``    -- coarse-to-fine peak search and scoring
- ``models``   -- the unrolled ADMM-Net (torch.nn)
- ``train``    -- losses, schedule, checkpoints and the training loop
- ``cli``      -- entry points

Importing the package builds nothing and needs no GPU.
"""

__version__ = "0.1.0"
