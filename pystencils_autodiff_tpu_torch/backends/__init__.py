"""Framework bridges (the port of ``pystencils_autodiff_tpu/backends/``):

* ``torch`` — ``AutoDiffOp.torch_function``, the ``psat::stencil`` custom op;
* ``torch_native`` — a ``torch.autograd.Function`` over the generated C
  kernels registered as PyTorch operators (CPU tensors) and the window
  kernel (CUDA tensors), ``_torch.py``;
* ``tensorflow`` — ``tf.custom_gradient`` + ``tf.py_function`` over
  ``torch_function``, tensors crossing by DLPack, ``_tensorflow.py``;
* ``tensorflow_native`` — a compiled TensorFlow custom-op library
  (``REGISTER_OP``), ``_tensorflow_native.py``.

``_c_native.py`` holds the generated C kernels on numpy arrays
(``AutoDiffOp.create_native_op``, ``forward_kernel_cpu``,
``backward_kernel_cpu``); ``astnodes.py`` the translation units of the
extensions.  The port has no JAX backend.
"""

AVAILABLE_BACKENDS = ["torch", "torch_native", "tensorflow",
                      "tensorflow_native"]

__all__ = ["AVAILABLE_BACKENDS"]
