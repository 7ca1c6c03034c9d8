"""The analysis toolkit (counterpart of ``diffvit_tpu/analysis/``): the
mixed-precision search and the Hessian sensitivity it ranks by
(``mixed_precision``, the parts of ``hessian`` that ``--mixed`` uses), PSAQ
data generation (``datagen``, the CLI's ``--mode 2``), activation
harvesting, CKA, PGD and DDV (``activations``, ``cka``, ``pgd``, ``ddv``)
and the CKA drivers (``cka_drivers``)."""
