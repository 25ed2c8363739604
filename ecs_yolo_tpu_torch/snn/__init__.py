"""The spiking core of the port: neuron recurrences, surrogate gradient, and
the hand-written CUDA kernels behind them.

Six kernels, each a wrapper with a ``.launches`` counter and a plain
PyTorch version beside it (``route.plain_kernels()`` selects the plain
versions for comparisons):

===================================  =======================  ==============================================
wrapper                              source                   TPU kernel it replaces
===================================  =======================  ==============================================
``ecs_lif.ecs_lif_fused``            ``csrc/ecs_lif.cu``      ``snn/pallas_ecs_v3.py:ecs_lif_pallas``
``fused.ecs_lif_fused_rows``         ``csrc/ecs_lif_rows.cu`` ``snn/pallas_kernels.py:ecs_lif_fused``
``fused.lif_fused``                  ``csrc/lif_fused.cu``    ``snn/pallas_kernels.py:lif_fused``
``fused.ecs_lif_fused_v2``           ``csrc/ecs_lif_v2.cu``   ``snn/pallas_kernels.py:ecs_lif_fused_v2``
``spread.binary_dw3_conv``           ``csrc/spread_dw3.cu``   ``snn/pallas_dw.py:binary_dw3_conv``
``spread.packed_spread``             ``csrc/spread_gemm.cu``  ``snn/pallas_dw.py:packed_spread_pallas``
===================================  =======================  ==============================================

The first three are the eval routes of a neuron site (``nn/blocks.MemUpdate``
chooses); ``ecs_lif_fused_v2`` computes the second's function with its state
in shared memory and, as in the JAX package, is reached only through its own
entry point; the last two run the spread inside the training T-loop.  The
kernel benches of ``scripts/bench_pallas_dw.py`` (``pallas_dw3`` on
``csrc/spread_dw3.cu``, ``pallas_dense3`` on ``csrc/dense3.cu``) live in
``ecs_yolo_tpu_torch/scripts/``.
"""
