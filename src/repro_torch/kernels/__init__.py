"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

* ``csrc/*.cu`` — the kernels (``clock_bid_eval``, ``sparse_bid_eval``,
  ``sparse_bid_eval_csr``, ``wkv6``, ``ordered_scatter``, ``ordered_rows``);
* :mod:`.build` — compiles them with ``nvcc`` at first use, loads them;
* :mod:`.ops` — the wrappers (plain version on CPU tensors, kernel on CUDA
  tensors), launch counters and the auction's demand-fn adapters;
* :mod:`.ref` — the plain versions and the float folds they share.
"""
