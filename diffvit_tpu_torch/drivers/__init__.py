"""The analysis drivers, the port's copies of the repository's root
scripts ``layerwise_quant_compare.py``, ``ddv_hessian_calc.py``,
``modeldiff_p2.py`` and ``examples/ddv_cka_calc.py``: the same flags and
defaults, ``--device`` cuda (default) or cpu.  Each runs as
``python3 -m diffvit_tpu_torch.drivers.<name>``."""
