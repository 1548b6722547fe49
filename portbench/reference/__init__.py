"""The frozen reference: plain PyTorch and NumPy, no code of the program.

``model``: the decoder blocks (attention and a gated MLP), the loss and
its gradients in float32, and the TF32 control; ``adamw``: the
optimizer step; ``ckpt_reader``: ``manifest.json`` and the single-file
layout read back byte for byte. Nothing here imports the program or JAX.
"""
