"""Static analysis over the port's checkpoint stack.

``crlint`` is the JAX package's durability/concurrency linter, carried byte
for byte (it is stdlib ``ast`` only). Its gate over this package reads the
port's own baseline:

    PYTHONPATH=src python -m repro_torch.analysis.crlint \\
        --baseline crlint_baseline_torch.txt src/repro_torch
"""
