"""PyTorch/CUDA port of the BoundSwitch packet-forwarding system.

A package of its own beside the JAX reference (``repro``): it imports
``torch``, ``numpy`` and the standard library only.  Packets and packed
weights travel as ``torch.int32`` tensors holding the same 32 bits as the
reference's ``uint32`` arrays.  Entry points run on the CUDA device unless
the caller passes ``device="cpu"``.
"""
