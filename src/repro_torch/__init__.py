"""PyTorch/CUDA port of the market-economy provisioning system (``repro``).

The JAX package ``repro`` is the reference and stays as it is; this package
imports neither it nor JAX.  Module names follow the reference so each
counterpart is easy to find: :mod:`repro_torch.core` holds the auction and
the economy, :mod:`repro_torch.kernels` the hand-written CUDA kernels for
Hopper (``sm_90a``) with their plain PyTorch versions.  Entry points run on
the card (``device="cuda"``) unless the caller asks for the CPU.
"""
