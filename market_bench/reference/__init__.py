"""Plain PyTorch and NumPy reference of the market, written apart from the
program: it imports nothing of ``repro_torch`` and takes nothing the program
made."""
