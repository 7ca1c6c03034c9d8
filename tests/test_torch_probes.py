"""The probes' plain versions (diffvit_tpu_torch/probes) against the
Pallas kernels of the scripts they stand for, run in interpret mode on the
CPU, on seeded numpy inputs at a small size.

The kernel bodies are the scripts' own text: the module-level ones
(``overlap_probe.k_*``, ``overlap_probe_mlp._kernel``) are imported from
the script file with their size globals set by ``monkeypatch``; the ones
nested in ``main()`` (``producer_part``, ``consumer_part``,
``paired_kernel``, ``_nv_kernel``, ``_sum_kernel``) are taken from the
script's syntax tree and compiled into a namespace holding the names they
close over."""
import ast
import functools
import importlib.util
import inspect
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from diffvit_tpu.ops.pallas.attention import _lis_body
from diffvit_tpu_torch.probes import (attn_overlap, ingest, overlap,
                                      overlap_mlp, pingpong, timing)

from test_torch_calibrate import one_torch_thread  # noqa: F401

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
# P1 and P5: B images of NP rows (N real), H heads of D; small, and one
# image at the scripts' DeiT-S geometry
GEOMETRIES = {"small": (2, 24, 21, 2, 16), "deit_s": (1, 200, 197, 6, 64)}
SCAL = [2.0**-4, 0.05, 24.0, 1.3]  # the scripts' [s_a, c1, 1/s1, s1/s2]


def _script(name):
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _nested(name, functions, namespace):
    """Compile the FunctionDefs ``functions`` of the script's ``main()``
    into ``namespace``; returns them."""
    path = SCRIPTS / f"{name}.py"
    tree = ast.parse(path.read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    defs = [n for n in main.body
            if isinstance(n, ast.FunctionDef) and n.name in functions]
    assert [d.name for d in defs] == list(functions)
    exec(compile(ast.Module(body=defs, type_ignores=[]), str(path), "exec"),
         namespace)
    return [namespace[f] for f in functions]


def _full(shape):
    return pl.BlockSpec(shape, lambda i: (0,) * len(shape))


def _per_image(shape):
    rest = (0,) * (len(shape) - 1)
    return pl.BlockSpec((1, *shape[1:]), lambda i: (i, *rest))


def _assert_codes(got, want, exact=True):
    """int8 outputs: >= 99.9% equal and max |diff| <= 1; equal where
    ``exact``."""
    got, want = np.asarray(got, np.int64), np.asarray(want, np.int64)
    assert got.shape == want.shape
    share = float(np.mean(got == want))
    max_diff = int(np.abs(got - want).max())
    if exact:
        assert share == 1.0, (share, max_diff)
    assert share >= 0.999 and max_diff <= 1, (share, max_diff)
    return share


@pytest.fixture(scope="module", params=sorted(GEOMETRIES))
def p1_operands(request):
    B, NP, N, H, D = GEOMETRIES[request.param]
    C = H * D
    rng = np.random.default_rng(1)
    x = rng.integers(-128, 128, (B, NP, C)).astype(np.int8)
    w = rng.integers(-8, 8, (C, 3 * C)).astype(np.int8)
    mult = np.full(3 * C, 2.0**-9, np.float32)
    bias = (rng.standard_normal(3 * C) * 0.01).astype(np.float32)
    scal = np.asarray(SCAL, np.float32)
    mb = np.stack([mult * scal[2], bias * scal[2]]).astype(np.float32)
    scores = rng.integers(-128, 128, (B, H, NP, NP)).astype(np.int8)
    v = rng.integers(-128, 128, (B, H, NP, D)).astype(np.int8)
    return dict(x=x, w=w, mult=mult, bias=bias, scal=scal, mb=mb,
                scores=scores, v=v, geometry=(B, NP, N, H, D))


@pytest.fixture(scope="module")
def p1_jax(p1_operands):
    """The script's producer, consumer and paired Pallas kernels on the
    operands, in interpret mode."""
    o = p1_operands
    B, NP, N, H, D = o["geometry"]
    C = H * D
    producer_part, consumer_part, paired_kernel = _nested(
        "ab_pingpong_probe", ("producer_part", "consumer_part",
                              "paired_kernel"),
        dict(jax=jax, jnp=jnp, pl=pl, H=H, D=D, C=C, _lis_body=_lis_body))
    sco_shape, o_shape = (B, H, NP, NP), (B, H, NP, D)
    ins = dict(x=_per_image((B, NP, C)), w=_full((C, 3 * C)),
               mb=_full((2, 3 * C)), scal=_full((4,)),
               scores=_per_image(sco_shape), v=_per_image(o_shape))

    def call(kernel, names, outs):
        return pl.pallas_call(
            kernel, grid=(B,), in_specs=[ins[n] for n in names],
            out_specs=[_per_image(s) for s in outs],
            out_shape=[jax.ShapeDtypeStruct(s, jnp.int8) for s in outs],
            interpret=True)(*(jnp.asarray(o[n]) for n in names))

    consumer = functools.partial(consumer_part, n_real=N, bits=4)
    paired = functools.partial(paired_kernel, n_real=N, bits=4)
    return dict(
        producer=call(producer_part, ("x", "w", "mb", "scal"),
                      [sco_shape])[0],
        consumer=call(consumer, ("scores", "v", "scal"), [o_shape])[0],
        paired=call(paired, ("x", "w", "mb", "scores", "v", "scal"),
                    [sco_shape, o_shape]))


def _torch(o, *names):
    return [torch.from_numpy(np.asarray(o[n])) for n in names]


def test_pingpong_producer_matches_script(p1_operands, p1_jax):
    """P1's producer: the int8 scores equal the script's bit for bit."""
    _, _, _, H, D = p1_operands["geometry"]
    x, w, mb, scal = _torch(p1_operands, "x", "w", "mb", "scal")
    got = pingpong.producer(x, w, mb, scal, num_heads=H, head_dim=D)
    _assert_codes(got, p1_jax["producer"])


def test_pingpong_consumer_matches_script(p1_operands, p1_jax):
    """P1's consumer (the fast LIS at s_a = 2^-4, then attn@v): the port's
    exact LIS against the script's, >= 99.9% of codes equal.  Measured: 100%
    at the small geometry; 99.9375% at the DeiT-S one, where 48 of 76,800
    codes differ (39 by 1, 7 by 2, 2 by 3).  The cause is inside the
    script's LIS, not around it: with the script's own weights
    (``_lis_body`` on the same scores) swapped into the port's attn@v and
    requant, every code equals the script's.  At s_a = 2^-4 rows meet
    exact ties of rint(exp_sum / exp_int), which XLA's CPU exp2 (an ulp off
    for some integers) breaks the other way, as PERF.md records for K4's
    LIS."""
    N = p1_operands["geometry"][2]
    scores, v, scal = _torch(p1_operands, "scores", "v", "scal")
    got = pingpong.consumer(scores, v, scal, n_real=N)
    want = np.asarray(p1_jax["consumer"])
    assert float(np.mean(got.numpy() == want)) >= 0.999
    npad = scores.shape[-1]
    weights = _lis_body(jnp.asarray(p1_operands["scores"], jnp.float32),
                        jnp.float32(SCAL[0]), 4, jnp.arange(npad) < N,
                        fast=True)
    o = torch.matmul(torch.tensor(np.asarray(weights, np.float64)),
                     v.to(torch.float64)).to(torch.float32)
    swapped = torch.clamp(torch.round(o * scal[3]), -128, 127)
    np.testing.assert_array_equal(swapped.numpy(), want)


def test_pingpong_paired_equals_its_halves(p1_operands, p1_jax):
    """paired is the producer and the consumer in one launch: in the
    script and in the port its two outputs equal the halves' bit for bit."""
    _, _, N, H, D = p1_operands["geometry"]
    x, w, mb, scores, v, scal = _torch(p1_operands, "x", "w", "mb", "scores",
                                       "v", "scal")
    sco, out = pingpong.paired(x, w, mb, scores, v, scal, num_heads=H,
                               head_dim=D, n_real=N)
    assert torch.equal(sco, pingpong.producer(x, w, mb, scal, num_heads=H,
                                              head_dim=D))
    assert torch.equal(out, pingpong.consumer(scores, v, scal, n_real=N))
    np.testing.assert_array_equal(p1_jax["paired"][0], p1_jax["producer"])
    np.testing.assert_array_equal(p1_jax["paired"][1], p1_jax["consumer"])


def test_linear_attention_matches_script(p1_operands):
    """P5 (K1 with w = a * 2^-7 over all Npad keys) equals the script's
    _nv_kernel bit for bit: a * 2^-7 is exact in bfloat16 and its products
    with v sum exactly in float32."""
    o = p1_operands
    B, NP, _, H, D = o["geometry"]
    C = H * D
    (nv_kernel,) = _nested("ab_attn_overlap_r3", ("_nv_kernel",),
                           dict(jax=jax, jnp=jnp, C=C, H=H, D=D))
    want = pl.pallas_call(
        nv_kernel, grid=(B,),
        in_specs=[_per_image((B, NP, C)), _full((C, 3 * C)),
                  _full((2, 3 * C)), _full((4,))],
        out_specs=_per_image((B, H, NP, D)),
        out_shape=jax.ShapeDtypeStruct((B, H, NP, D), jnp.int8),
        interpret=True)(*(jnp.asarray(o[n]) for n in ("x", "w", "mb", "scal")))
    x, w, mult, bias, scal = _torch(o, "x", "w", "mult", "bias", "scal")
    got = attn_overlap.qkv_attention_nv(x, w, mult, bias, scal, num_heads=H,
                                        head_dim=D)
    _assert_codes(got, want)


@pytest.mark.parametrize("mode,kernel", [
    ("dot_only", "k_dot"), ("vpu_only", "k_vpu"),
    ("dot_vpu_consume", "k_dot_vpu_consume"),
    ("dot_vpu_in_join", "k_dot_vpu_input_join"),
    ("dot_vpu_in_split", "k_dot_vpu_input_split")])
def test_overlap_matches_script(monkeypatch, mode, kernel):
    """P2's five modes against the script's kernels (2 blocks of 32 rows, a
    32-deep dot, 8 chain steps), within overlap.compare's tolerances: the
    dot's summation order (2^-13 of sum |a b|) and the tanh chain's
    roundings (2^-18 of max(1, |x|))."""
    script = _script("overlap_probe")
    rows, k, n, iters = 64, 32, 32, 8
    monkeypatch.setattr(script, "M", 32)
    monkeypatch.setattr(script, "N", n)
    monkeypatch.setattr(script, "VPU_ITERS", iters)
    a, b, v = overlap.inputs("cpu", rows)
    a, b = a[:, :k].contiguous(), b[:k, :n].contiguous()
    v = v[:, :n].contiguous()
    j = lambda t: jnp.asarray(t.to(torch.float32).numpy()) \
        .astype(jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)
    want = pl.pallas_call(
        getattr(script, kernel), grid=(2,),
        in_specs=[pl.BlockSpec((32, k), lambda i: (i, 0)),
                  pl.BlockSpec((k, n), lambda i: (0, 0)),
                  pl.BlockSpec((32, n), lambda i: (i, 0))],
        out_specs=[pl.BlockSpec((32, n), lambda i: (i, 0))] * 2,
        out_shape=[jax.ShapeDtypeStruct((rows, n), jnp.float32)] * 2,
        interpret=True)(j(a), j(b), j(v))
    got = overlap.KERNELS[mode](a, b, v, iters=iters)
    share, max_err, ok = overlap.compare(
        mode, a, b, got, [torch.tensor(np.asarray(w)) for w in want], iters)
    assert ok, (share, max_err)


@pytest.mark.parametrize("mode", overlap.MODES)
def test_overlap_compare_rejects_a_wrong_output(mode):
    """overlap.compare is tight enough to see a wrong result: the plain
    outputs pass, and the largest element of the output that carries the
    mode's work, moved by 1e-3 of max(1, |x|), fails (for consume: out of
    the interval between the chains of y -+ its tolerance)."""
    a, b, v = overlap.inputs("cpu", 64)
    a, b = a[:, :32].contiguous(), b[:32, :64].contiguous()
    v = v[:, :64].contiguous()
    want = overlap.overlap_plain(a, b, v, mode, 8)
    assert overlap.compare(mode, a, b, want, want, 8)[2]
    bad = [w.clone() for w in want]
    o = bad[1 if mode == "vpu_only" else 0].view(-1)
    i = int(o.abs().argmax())
    o[i] += 1e-3 * max(1.0, abs(float(o[i])))
    assert not overlap.compare(mode, a, b, bad, want, 8)[2]


def test_timing_summarizes_rounds_and_needs_a_card():
    """The legs' numbers are medians with their min and max over rounds;
    chain_ms refuses to time without a card."""
    rounds = [{"a": 3.0, "b": 1.0}, {"a": 1.0, "b": 2.0},
              {"a": 2.0, "b": 9.0}]
    assert timing.spread(rounds) == {
        "a": {"median": 2.0, "min": 1.0, "max": 3.0},
        "b": {"median": 2.0, "min": 1.0, "max": 9.0}}
    assert timing.medians(rounds) == {"a": 2.0, "b": 2.0}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            timing.chain_ms(lambda: None)


@pytest.mark.parametrize("probe", [attn_overlap, ingest, overlap, overlap_mlp,
                                   pingpong])
def test_probe_legs_take_only_the_device(probe):
    """Each probe's legs run at its module's fixed geometry and timing's
    counts: the device is their only argument."""
    assert list(inspect.signature(probe.legs).parameters) == ["dev"]


@pytest.mark.parametrize("mode", ["dot", "input", "nogelu", "pipelined",
                                  "staged"])
def test_overlap_mlp_matches_script(monkeypatch, mode):
    """P3's four modes against the script's _kernel (blocks of 64 rows, two
    sub-blocks of 32, 32 -> 64 -> 32 wide): the codes on the out_scale grid
    >= 99.9% equal and |diff| <= 1 (XLA may contract a multiply-add into an
    fma), and where the codes agree the float32 outputs within 1e-6 (the
    keep-alive term mid * 1e-8 is below 1e-5)."""
    script = _script("overlap_probe_mlp")
    block, sub, cin, hid, rows = 64, 32, 32, 64, 128
    for name, value in (("BLOCK", block), ("SUB", sub), ("CIN", cin)):
        monkeypatch.setattr(script, name, value)
    rng = np.random.default_rng(3)
    ops = [np.clip(np.round(rng.standard_normal((rows, cin)) * 10), -128,
                   127).astype(np.int8),
           rng.integers(-127, 128, (cin, hid)).astype(np.int8),
           rng.integers(-127, 128, (hid, cin)).astype(np.int8),
           np.outer([1e-3, 0.0], np.ones(hid)).astype(np.float32),
           np.outer([1e-3, 0.0, 0.05, 20.0], np.ones(cin)).astype(np.float32),
           rng.standard_normal((rows, hid)).astype(np.float32),
           np.asarray([16.0], np.float32)]
    whole = [_full(a.shape) for a in ops]
    want = np.asarray(pl.pallas_call(
        # staged is the port's fifth mode: the function of the script's dot
        functools.partial(script._kernel,
                          mode={"staged": "dot"}.get(mode, mode)),
        grid=(rows // block,),
        in_specs=[pl.BlockSpec((block, cin), lambda i: (i, 0)), *whole[1:5],
                  pl.BlockSpec((block, hid), lambda i: (i, 0)), whole[6]],
        out_specs=pl.BlockSpec((block, cin), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((rows, cin), jnp.float32),
        interpret=True)(*map(jnp.asarray, ops)))
    got = overlap_mlp.KERNELS[f"mlp_{mode}"](*map(torch.from_numpy, ops))
    got = got.numpy()
    codes = lambda y: np.round(y / np.float32(0.05))  # noqa: E731
    _assert_codes(codes(got), codes(want), exact=False)
    same = codes(got) == codes(want)
    np.testing.assert_allclose(got[same], want[same], rtol=0, atol=1e-6)


@pytest.mark.parametrize("values", ["uint8", "halves"])
def test_tile_sum_matches_script(values):
    """P4 against the script's _sum_kernel over 8 sequential grid steps, on
    a (64, 128) float32 array whose float32 sum is exact (integers <= 254,
    sum < 2^24; or halves): bit for bit."""
    (sum_kernel,) = _nested("ab_regime_discriminate", ("_sum_kernel",),
                            dict(jnp=jnp, pl=pl))
    rng = np.random.default_rng(4)
    x = rng.integers(0, 255, (64, 128)).astype(np.float32)
    if values == "halves":
        x = np.full((64, 128), 0.5, np.float32)
    want = pl.pallas_call(
        sum_kernel, grid=(8,),
        in_specs=[pl.BlockSpec((8, 128), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((8, 128), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        interpret=True)(jnp.asarray(x))
    got = ingest.tile_sum(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(got[0, 0]) == float(x.astype(np.float64).sum())


STAGE = ingest.STAGE_BYTES // 4  # elements a full ring stage


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("n", [4, 16, STAGE - 4, STAGE + 4, 7 * STAGE,
                               9_633_792])
def test_tile_sum_plan_covers_the_input_once(n, sms):
    """P4's launch plan: the blocks' bulk copies cover [0, n) once, in
    order, each starting and ending on a 16-byte boundary and at most a
    stage long; no block is empty; at most one block an SM; the ring fits
    a block's shared memory; and summing the input
    copy by copy, block by block, gives the plain version's tile."""
    from diffvit_tpu_torch.ops.kernels.gemm import SMEM_LIMIT
    p = ingest.plan(n, sms)
    assert 1 <= p.grid <= sms
    assert p.share % 4 == 0 and p.grid * p.share >= n
    assert ingest.RING_OFFSET + p.stages * p.stage_bytes <= p.smem \
        <= SMEM_LIMIT
    assert 2 <= p.stages <= ingest.MAX_STAGES
    assert p.stage_bytes == ingest.STAGE_BYTES
    copies = [r for b in range(p.grid) for r in p.stage_ranges(b)]
    assert all(p.stage_ranges(b) for b in range(p.grid))
    assert copies[0][0] == 0 and copies[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(copies, copies[1:]))
    for lo, hi in copies:
        assert lo * 4 % 16 == 0 and (hi - lo) * 4 % 16 == 0
        assert 0 < (hi - lo) * 4 <= p.stage_bytes
    x = torch.from_numpy(np.random.default_rng(n).integers(
        0, 255, n).astype(np.float32))
    partials = [sum(float(x[lo:hi].to(torch.float64).sum())
                    for lo, hi in p.stage_ranges(b)) for b in range(p.grid)]
    total = np.float32(sum(partials))
    assert torch.equal(torch.full((8, 128), float(total)),
                       ingest.tile_sum_plain(x))


def test_tile_sum_plan_takes_a_multiple_of_4():
    """An empty input is one block with nothing to copy; a count that is
    not a multiple of 4 has no 16-byte copies and is refused, as is a ring
    that does not fit its blocks an SM; two blocks an SM halve the
    shares."""
    p = ingest.plan(0)
    assert (p.grid, p.share, p.stage_ranges(0)) == (1, 0, [])
    with pytest.raises(ValueError):
        ingest.plan(6)
    one = ingest.plan(9_633_792)
    assert one.stage_bytes == ingest.STAGE_BYTES
    with pytest.raises(ValueError):  # 2 x 6 x 32 KB do not fit an SM
        ingest.plan(4096, blocks=2)
    two = ingest.plan(9_633_792, blocks=2, stages=3)
    assert two.grid == 264 and two.share == one.share // 2


WRAPPERS = {
    "producer": lambda t: pingpong.producer(t["i8"], t["i8"], t["f32"],
                                            t["f32"], num_heads=1,
                                            head_dim=4),
    "consumer": lambda t: pingpong.consumer(t["i8"], t["i8"], t["f32"],
                                            n_real=4),
    "paired": lambda t: pingpong.paired(t["i8"], t["i8"], t["f32"], t["i8"],
                                        t["i8"], t["f32"], num_heads=1,
                                        head_dim=4, n_real=4),
    "qkv_attention_nv": lambda t: attn_overlap.qkv_attention_nv(
        t["i8"], t["i8"], t["f32"], t["f32"], t["f32"], num_heads=1,
        head_dim=4),
    "tile_sum": lambda t: ingest.tile_sum(t["f32"]),
    **{name: (lambda t, f=f: f(t["bf16"], t["bf16"], t["f32"]))
       for name, f in overlap.KERNELS.items()},
    **{name: (lambda t, f=f: f(t["i8"], t["i8"], t["i8"], t["f32"], t["f32"],
                               t["f32"], t["f32"]))
       for name, f in overlap_mlp.KERNELS.items()},
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_probe_wrapper_refuses_other_devices(name):
    """Every probe wrapper takes its plain version only for CPU tensors: a
    tensor on another device (here 'meta'), or tensors on several devices,
    raise instead of falling back."""
    meta = {k: torch.zeros(4, 4, dtype=dt, device="meta") for k, dt in (
        ("i8", torch.int8), ("f32", torch.float32), ("bf16", torch.bfloat16))}
    with pytest.raises(ValueError):
        WRAPPERS[name](meta)
    if name == "tile_sum":
        return  # one tensor: nothing to mix
    mixed = dict(meta, i8=torch.zeros(4, 4, dtype=torch.int8))
    if name in overlap.KERNELS:
        mixed = dict(meta, f32=torch.zeros(4, 4))
    with pytest.raises(ValueError):
        WRAPPERS[name](mixed)


def test_probe_library_is_apart_from_the_served_one():
    """The probes build their own library from csrc/probes with their own
    entries; the served library's sources and entries do not change."""
    from diffvit_tpu_torch.ops.kernels import build
    probes, served = build.LIBRARIES["probes"], build.LIBRARIES["kernels"]
    assert build.library_path("probes").name.startswith("libdvt_probes_")
    assert build.library_path().name.startswith("libdvt_kernels_")
    assert {p.name for p in probes.src_dir.glob("*.cu")} == {
        "attn_nv.cu", "ingest.cu", "overlap.cu", "overlap_mlp.cu",
        "pingpong.cu"}
    assert not set(probes.entries) & set(served.entries)
    assert served.src_dir == build.CSRC and served.entries is build.ENTRIES
