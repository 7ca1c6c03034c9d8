"""Post-training calibration observers (counterpart of
``diffvit_tpu/calib/``)."""
