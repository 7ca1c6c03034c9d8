"""The analysis toolkit (counterpart of ``diffvit_tpu/analysis/``): the
mixed-precision search and the Hessian it ranks by (``mixed_precision``;
``hessian``: Hutchinson traces, and the spectrum by power iteration and
stochastic Lanczos), PSAQ data generation (``datagen``, the CLI's
``--mode 2``), activation harvesting, CKA, PGD and DDV (``activations``,
``cka``, ``pgd``, ``ddv``), the CKA drivers (``cka_drivers``), the
DDV-Hessian sensitivity (``ddv_hessian``), the ModelDiff input search
(``modeldiff``), layer-restore sweeps (``restore``) and plotting
(``plotting``, matplotlib imported only when it draws).  The command-line
drivers over them are ``diffvit_tpu_torch/drivers``."""
