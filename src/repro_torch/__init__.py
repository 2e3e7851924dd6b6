"""PyTorch/CUDA port of the ``repro`` package (Qm.n quantized LM serving).

Module names follow ``repro`` so each file's counterpart is easy to find.
The port imports ``torch``, numpy and the standard library only; the JAX
package is its reference and only the tests import both.  Every entry point
runs on ``cuda`` unless the caller passes ``device="cpu"``.
"""
