"""latteclip_torch lab kernels: the plain versions against the Pallas bodies
of the two lab tools, ``tools/attn_lab.py`` and ``tools/r4_transpose_probe.py``,
and the port's lab tools run on the CPU.

The Pallas bodies run in interpret mode: ``pl.pallas_call`` is patched to
``interpret=True`` and the tools' shape globals (B, L, H, D, HD, G) are set
small, both with ``monkeypatch``, so nothing under ``tools/`` changes. The
probe's kernels are called through a ``pallas_call`` built as
``r4_transpose_probe.py:80-91`` builds it. Inputs are made with numpy and
rounded to bf16 identically on both sides: q and k ~ N(0, 0.3^2), v and the
cotangent ~ N(0, 1) for the attention (as the kernel tests draw them),
N(0, 1) for the products (as the probe draws them).

Tolerances, and why:
* lab forward o: elementwise atol = rtol = 2e-2 and ||o - ref|| / ||ref||
  <= 1e-2, as for every bf16 attention output of the port: both sides round
  p to bf16 at the same point, and an exp or f32 summation order that
  differs by an ulp can flip one such rounding;
* lab forward lse: atol 1e-5. lse = m + ln(l) with l the sum of the
  unrounded p, so no bf16 rounding enters it: only f32 summation order and
  exp's last bits differ (observed <= 5e-7);
* lab backward dq, dk, dv: ||d - ref|| / ||ref|| <= 1e-2 and
  max|d - ref| <= 2e-2 * max|ref| each, the bounds of the flash backward
  (each gradient rounded to bf16 once, < 2^-8 relative; a flipped bf16
  rounding of one p or ds moves a sum of L terms by far less);
* head-summed Q K^T and P V, f32 out: ||S - ref|| / ||ref|| <= 1e-5 and
  max|S - ref| <= 1e-5 * max|ref|. Products of two bf16 values are exact in
  f32, so the sides differ only in f32 summation order (observed ~1e-7).
"""
import ast
import functools
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import tools.attn_lab as AL  # noqa: E402
import tools.r4_transpose_probe as TP  # noqa: E402

from latteclip_torch.kernels import lab as LB  # noqa: E402
from latteclip_torch.tools import attn_lab as port_attn_lab  # noqa: E402
from latteclip_torch.tools import r4_transpose_probe as port_probe  # noqa: E402

torch.set_num_threads(1)

OUT_TOL = 2e-2
OUT_REL_TOL = 1e-2
LSE_TOL = 1e-5
GRAD_REL_TOL = 1e-2
GRAD_MAX_TOL = 2e-2
F32_REL_TOL = 1e-5
G = 2  # the TPU tools' row grouping, which the port does not take


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _set_shape(monkeypatch, module, B, L, H, D):
    for name, value in dict(B=B, L=L, H=H, D=D, HD=H * D, G=G).items():
        if hasattr(module, name):  # attn_lab passes G as an argument
            monkeypatch.setattr(module, name, value)


def _draw(rng, shape, std=1.0):
    """(bf16 jax array, bf16 torch tensor) of the same values."""
    x = (rng.standard_normal(shape) * std).astype(np.float32)
    t = torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(t.float().numpy(), jnp.bfloat16), t


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if isinstance(x, jax.Array) else x.float().numpy()


def _assert_out_close(ours, ref):
    a, r = _np(ours), _np(ref)
    assert a.shape == r.shape
    np.testing.assert_allclose(a, r, atol=OUT_TOL, rtol=OUT_TOL)
    assert np.linalg.norm(a - r) <= OUT_REL_TOL * np.linalg.norm(r)


def _assert_grad_close(ours, ref):
    a, r = _np(ours), _np(ref)
    assert a.shape == r.shape
    assert np.linalg.norm(a - r) <= GRAD_REL_TOL * np.linalg.norm(r)
    assert np.abs(a - r).max() <= GRAD_MAX_TOL * np.abs(r).max()


def _assert_f32_close(ours, ref):
    a, r = _np(ours), _np(ref)
    assert a.shape == r.shape
    assert np.linalg.norm(a - r) <= F32_REL_TOL * np.linalg.norm(r)
    assert np.abs(a - r).max() <= F32_REL_TOL * np.abs(r).max()


def _qkv(B, L, H, D, seed):
    rng = np.random.default_rng(seed)
    return [_draw(rng, (B, L, H * D), std) for std in (0.3, 0.3, 1.0)]


def _bhld(x, B, L, H, D):
    return x.reshape(B, L, H, D).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("L", [50, 77])
def test_lab_forward_packed_plain_matches_pallas_v1(interpret, monkeypatch, L):
    B, H, D = 4, 2, 64
    _set_shape(monkeypatch, AL, B, L, H, D)
    (qj, q), (kj, k), (vj, v) = _qkv(B, L, H, D, seed=L)
    ref_o, ref_lse = AL.fwd_v1g(qj, kj, vj, G)
    o, lse = LB.lab_fwd_packed(q, k, v, H)
    assert o.dtype == torch.bfloat16 and lse.shape == (B, H, L)
    _assert_out_close(o, ref_o)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=LSE_TOL, rtol=0)


@pytest.mark.parametrize("L", [50, 77])
def test_lab_forward_bhld_plain_matches_pallas_v3(interpret, monkeypatch, L):
    B, H, D = 4, 2, 64
    _set_shape(monkeypatch, AL, B, L, H, D)
    (qj, q), (kj, k), (vj, v) = _qkv(B, L, H, D, seed=L + 1)
    qb, kb, vb = (LB.to_bhld(x, H).contiguous() for x in (q, k, v))
    ref_o, ref_lse = AL.fwd_v3(*(_bhld(x, B, L, H, D) for x in (qj, kj, vj)), G)
    o, lse = LB.lab_fwd_bhld(qb, kb, vb)
    assert lse.shape == (H, B, L)
    _assert_out_close(o, ref_o)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=LSE_TOL, rtol=0)
    # fwd_v3_packed: the same kernel between permutes
    ref_o, ref_lse = AL.fwd_v3_packed(qj, kj, vj, G)
    o, lse = LB.lab_fwd_v3_packed(q, k, v, H)
    assert o.shape == (B, L, H * D)
    _assert_out_close(o, ref_o)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=LSE_TOL, rtol=0)


@pytest.mark.parametrize("L", [50, 77])
def test_lab_backward_plain_matches_pallas_v3(interpret, monkeypatch, L):
    """From one lse (the Pallas forward's) and one cotangent."""
    B, H, D = 4, 2, 64
    _set_shape(monkeypatch, AL, B, L, H, D)
    (qj, q), (kj, k), (vj, v) = _qkv(B, L, H, D, seed=L + 2)
    doj, do = _draw(np.random.default_rng(L + 3), (B, H, L, D))
    js = [_bhld(x, B, L, H, D) for x in (qj, kj, vj)]
    _, lse_j = AL.fwd_v3(*js, G)
    ref = AL.bwd_v3(*js, doj, lse_j, G)
    ts = [LB.to_bhld(x, H).contiguous() for x in (q, k, v)]
    ours = LB.lab_bwd_bhld(*ts, do, torch.from_numpy(np.array(lse_j)))
    for a, r in zip(ours, ref):
        assert a.dtype == torch.bfloat16
        _assert_grad_close(a, r)


def test_lab_forward_then_backward_matches_pallas_chain(interpret, monkeypatch):
    """LabAttentionBHLD (plain forward and backward on the CPU) against
    fwd_v3 then bwd_v3, the JAX tool's f+b."""
    B, L, H, D = 4, 50, 2, 64
    _set_shape(monkeypatch, AL, B, L, H, D)
    (qj, q), (kj, k), (vj, v) = _qkv(B, L, H, D, seed=9)
    js = [_bhld(x, B, L, H, D) for x in (qj, kj, vj)]
    ref_o, lse_j = AL.fwd_v3(*js, G)
    doj = js[0]  # the JAX tool's cotangent, qb
    ref = AL.bwd_v3(*js, doj, lse_j, G)
    leaves = [LB.to_bhld(x, H).contiguous().requires_grad_(True) for x in (q, k, v)]
    o, lse = LB.LabAttentionBHLD.apply(*leaves)
    assert not lse.requires_grad
    grads = torch.autograd.grad(o, leaves, leaves[0].detach())
    _assert_out_close(o.detach(), ref_o)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=LSE_TOL, rtol=0)
    for a, r in zip(grads, ref):
        _assert_grad_close(a, r)


def _probe_call(kern, a, b, o_shape):
    """The probe's pallas_call, built as r4_transpose_probe.py:80-91 builds it."""
    spec = lambda shp: pl.BlockSpec(  # noqa: E731
        (TP.G,) + shp[1:], lambda i: (i,) + (0,) * (len(shp) - 1), memory_space=pltpu.VMEM)
    return pl.pallas_call(
        kern,
        grid=(a.shape[0] // TP.G,),
        in_specs=[spec(a.shape), spec(b.shape)],
        out_specs=spec(o_shape),
        out_shape=jax.ShapeDtypeStruct(o_shape, jnp.float32),
        compiler_params=pltpu.CompilerParams(vmem_limit_bytes=64 * 2**20),
    )(a, b)


@pytest.mark.parametrize("kind", ["natural", "pret", "pv"])
def test_head_summed_products_plain_match_pallas(interpret, monkeypatch, kind):
    B, L, H, D = 4, 77, 2, 64
    _set_shape(monkeypatch, TP, B, L, H, D)
    rng = np.random.default_rng(77)
    if kind == "pv":
        (aj, a), (bj, b) = _draw(rng, (B, L, L)), _draw(rng, (B, L, H * D))
        ref = _probe_call(TP._kern_pv, aj, bj, (B, L, D))
        ours = LB.pv_heads(a, b, H)
    else:
        (aj, a), (bj, b) = _draw(rng, (B, L, H * D)), _draw(rng, (B, L, H * D))
        if kind == "pret":
            bj, b = jnp.transpose(bj, (0, 2, 1)), b.transpose(1, 2).contiguous()
        ref = _probe_call(TP._kern_natural if kind == "natural" else TP._kern_pret, aj, bj, (B, L, L))
        ours = (LB.qk_heads_natural if kind == "natural" else LB.qk_heads_pret)(a, b, H)
    assert ours.dtype == torch.float32
    _assert_f32_close(ours, ref)


def test_lab_wrappers_take_plain_versions_on_cpu_without_counting():
    B, L, H, D = 2, 20, 2, 64
    rng = np.random.default_rng(3)
    q, k, v = (_draw(rng, (B, L, H * D))[1] for _ in range(3))
    p = _draw(rng, (B, L, L))[1]
    qb, kb, vb = (LB.to_bhld(x, H).contiguous() for x in (q, k, v))
    LB.reset_launch_counts()
    for ours, ref in (
        (LB.lab_fwd_packed(q, k, v, H), LB.lab_fwd_packed_plain(q, k, v, H)),
        (LB.lab_fwd_bhld(qb, kb, vb), LB.lab_fwd_bhld_plain(qb, kb, vb)),
    ):
        assert all(torch.equal(a, b) for a, b in zip(ours, ref))
    lse = LB.lab_fwd_bhld_plain(qb, kb, vb)[1]
    assert all(torch.equal(a, b) for a, b in zip(LB.lab_bwd_bhld(qb, kb, vb, qb, lse),
                                                 LB.lab_bwd_bhld_plain(qb, kb, vb, qb, lse)))
    kt = k.transpose(1, 2).contiguous()
    assert torch.equal(LB.qk_heads_natural(q, k, H), LB.qk_heads_natural_plain(q, k, H))
    assert torch.equal(LB.qk_heads_pret(q, kt, H), LB.qk_heads_pret_plain(q, kt, H))
    assert torch.equal(LB.pv_heads(p, v, H), LB.pv_heads_plain(p, v, H))
    assert LB.launch_counts == {"lab_fwd": 0, "lab_bwd": 0, "lab_qk": 0, "lab_pv": 0}


def test_lab_wrappers_do_not_fall_back_off_the_cpu():
    """A tensor that is neither on the CPU nor on a CUDA device is refused,
    never run through the plain version."""
    B, L, H, D = 2, 20, 2, 64
    x = torch.empty((B, L, H * D), dtype=torch.bfloat16, device="meta")
    xb = torch.empty((B, H, L, D), dtype=torch.bfloat16, device="meta")
    p = torch.empty((B, L, L), dtype=torch.bfloat16, device="meta")
    lse = torch.empty((H, B, L), dtype=torch.float32, device="meta")
    for call in (lambda: LB.lab_fwd_packed(x, x, x, H), lambda: LB.lab_fwd_bhld(xb, xb, xb),
                 lambda: LB.lab_fwd_v3_packed(x, x, x, H),
                 lambda: LB.lab_bwd_bhld(xb, xb, xb, xb, lse),
                 lambda: LB.qk_heads_natural(x, x, H),
                 lambda: LB.qk_heads_pret(x, x.transpose(1, 2), H), lambda: LB.pv_heads(p, x, H)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()


def test_port_lab_tools_run_on_cpu(capsys):
    assert port_attn_lab.main(["--device", "cpu", "--batch", "2", "--length", "20", "--heads", "2",
                               "--head-dim", "64", "--iters", "1"]) == 0
    out = capsys.readouterr().out
    for label in ("attn_lab: cpu", "v3 vs v1:", "current (K1) vs v1:", "K1 fwd (current",
                  "lab v1 fwd (packed):", "xpose there+back:", "lab v3 fwd (packed, permutes):",
                  "lab v3 fwd (BHLD):", "K1+K3 f+b (current):", "lab v3 f+b (BHLD):",
                  "SDPA fwd (BHLD):", "SDPA f+b (BHLD):"):
        assert label in out, label
    # the lab's v1 and v3 compute one function, so on the CPU they agree exactly
    assert "v3 vs v1: max|o| err = 0  max|lse| err = 0" in out
    assert port_probe.main(["--device", "cpu", "--batch", "2", "--length", "20", "--heads", "2",
                            "--head-dim", "64", "--iters", "1"]) == 0
    out = capsys.readouterr().out
    for label in ("r4_transpose_probe: cpu", "pret vs natural:", "natural   :", "pret      :",
                  "pv        :"):
        assert label in out, label


def test_port_lab_tools_refuse_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for tool in (port_attn_lab, port_probe):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tool.main(["--batch", "2", "--length", "20", "--heads", "2"])


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of latteclip_torch, the lab tools and lab kernels, the
    int8, importer, export, preprocess and native modules and the mesh and
    its smoke tool among them, and chip_smoke.py: no import of jax or
    latteclip_tpu."""
    files = sorted((ROOT / "latteclip_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    names = {str(f.relative_to(ROOT)) for f in files}
    assert {"latteclip_torch/kernels/lab.py", "latteclip_torch/tools/attn_lab.py",
            "latteclip_torch/tools/r4_transpose_probe.py",
            "latteclip_torch/tools/perf_lab.py", "latteclip_torch/models/quantize.py",
            "latteclip_torch/big_vision.py", "latteclip_torch/hf_hub.py",
            "latteclip_torch/native/__init__.py", "latteclip_torch/preprocess/captions.py",
            "latteclip_torch/preprocess/create_tarfiles.py",
            "latteclip_torch/preprocess/to_webdataset.py", "latteclip_torch/mesh.py",
            "latteclip_torch/tools/multihost_smoke.py"} <= {n.replace(os.sep, "/") for n in names}
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "latteclip_tpu", "tools")]
    assert not bad, bad
