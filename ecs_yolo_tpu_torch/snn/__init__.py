"""The spiking core of the port: neuron recurrences, surrogate gradient, and
the hand-written CUDA kernels behind them.

Five kernels, each a wrapper with a ``.launches`` counter and a plain
PyTorch version beside it (``route.plain_kernels()`` selects the plain
versions for comparisons):

===================================  =======================  ==============================================
wrapper                              source                   TPU kernel it replaces
===================================  =======================  ==============================================
``ecs_lif.ecs_lif_fused``            ``csrc/ecs_lif.cu``      ``snn/pallas_ecs_v3.py:ecs_lif_pallas``
``fused.ecs_lif_fused_rows``         ``csrc/ecs_lif_rows.cu`` ``snn/pallas_kernels.py:ecs_lif_fused``
``fused.lif_fused``                  ``csrc/lif_fused.cu``    ``snn/pallas_kernels.py:lif_fused``
``spread.binary_dw3_conv``           ``csrc/spread_dw3.cu``   ``snn/pallas_dw.py:binary_dw3_conv``
``spread.packed_spread``             ``csrc/spread_gemm.cu``  ``snn/pallas_dw.py:packed_spread_pallas``
===================================  =======================  ==============================================

The first three are the eval routes of a neuron site (``nn/blocks.MemUpdate``
chooses); the last two run the spread inside the training T-loop.
"""
