"""The mixed-precision search and the Hessian sensitivity it ranks by
(counterpart of ``diffvit_tpu/analysis/``: ``mixed_precision`` and the
parts of ``hessian`` that ``--mixed`` uses)."""
