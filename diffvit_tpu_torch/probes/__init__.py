"""H100 probes: the counterparts of the inline Pallas kernels of ``scripts/``.

Each probe keeps a hand-written CUDA kernel per Pallas kernel of its script
(``csrc/probes/*.cu``, built into their own library, ``libdvt_probes_*``),
a plain PyTorch version beside each, and a timing harness, ``legs()``, that
asks the script's question again on the card.  Each wrapper takes its
kernel for a CUDA tensor and its plain version for a CPU tensor, raises for
any other device, and counts its launches in ``.launches``.

    attn_overlap.py  P5 qkv_attention_nv (ab_attn_overlap_r3.py): K1 with
                     the LIS replaced by w = a * 2^-7; times K1, P5 and K8
    pingpong.py      P1 producer, consumer, paired (ab_pingpong_probe.py):
                     K1 split at the scores
    overlap.py       P2 dot_only, vpu_only, dot_vpu_consume,
                     dot_vpu_in_join, dot_vpu_in_split (overlap_probe.py)
    overlap_mlp.py   P3 mlp_dot, mlp_input, mlp_nogelu, mlp_pipelined
                     (overlap_probe_mlp.py) and mlp_staged: K2's structure
                     in five modes
    ingest.py        P4 tile_sum (ab_regime_discriminate.py): a reduction
                     fed from pageable, pinned and device memory

``python3 -m diffvit_tpu_torch.probes.<name>`` runs one probe's legs on the
card and prints its answer as one JSON line: medians with their min and max
over five rounds (``timing``)."""
