"""Time the lab kernels under launch plans other than their own, on the
card:

    python -m latteclip_torch.tools.lab_plans

For each shape, the packed lab forward (``latteclip_lab_fwd_packed``) runs
under its one-CTA-per-(b, h) form and under the ring at every count of CTAs
an SM that its registers allow and every stage count that fits; the lab
backward (``latteclip_lab_bwd_bhld``) under its one-CTA form and, at
head_dim 64 and up to 208 tokens, under the ring with one and (where two
fit) two resident items; the Q K^T from kT (``latteclip_lab_qk_pret``) and
the P V (``latteclip_lab_pv``) under their one-CTA-per-row form and under
the ring at one and two CTAs an SM (P V: two at head_dim 64 only) and every
stage count that fits. Each form is checked against the plain version (out
and lse, the gradients, or the f32 product, as ``chip_smoke.py`` holds them)
and timed with CUDA events, L2 flushed, median of ``--iters``. One JSON line
a shape: the plan that ``lab.lab_*_plan`` picks, its time, every form's
time, and the library calls' on the same operands (SDPA's forward, or its
backward alone; ``torch.bmm``; for P V also ``torch.einsum``, the one call
that sums the heads as the kernel does, where ``bmm`` keeps every head's
product). It answers how the plans' rules were chosen; the kernels and their
wrappers never read it.
"""
from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from latteclip_torch.kernels import lab
from latteclip_torch.tools.long_row_plans import agrees
from latteclip_torch.tools.perf_lab import Timer

# (B, L, H, D): the lab tool's shape and rows on each side of the forms'
# edges (one, two, three and four 64-row blocks; head_dim 128; one small)
FWD_SHAPES = (
    (512, 197, 12, 64), (512, 197, 6, 128), (512, 256, 12, 64), (512, 129, 12, 64),
    (512, 128, 12, 64), (512, 77, 12, 64), (512, 77, 6, 128), (512, 50, 12, 64),
    (4, 50, 2, 64),
)
# (B, L, H, D): the probe's shape, one and two warpgroups, one small
QK_SHAPES = ((1024, 77, 8, 64), (1024, 128, 8, 64), (1024, 50, 8, 64), (4, 77, 2, 64))
# (B, L, H, D): the lab tool's backward, head_dim 128 (the one-CTA form only),
# rows of two and three 64-row blocks with two resident items, one block,
# few items, one small
BWD_SHAPES = (
    (512, 197, 12, 64), (512, 197, 6, 128), (512, 144, 12, 64), (512, 128, 12, 64),
    (512, 77, 12, 64), (512, 50, 12, 64), (64, 197, 12, 64), (4, 50, 2, 64),
)
# (B, L, H, D): the probe's P V, two and one warpgroups, head_dim 128, one
# whole 16-key step, rows shorter than one step, one small
PV_SHAPES = (
    (1024, 77, 8, 64), (1024, 128, 8, 64), (1024, 50, 8, 64), (1024, 77, 4, 128),
    (1024, 16, 8, 64), (1024, 8, 8, 64), (1024, 1, 8, 64), (4, 77, 2, 64),
)
F32_REL_TOL = 1e-4  # chip_smoke.py's bound on the head-summed products
GRAD_REL_TOL, GRAD_MAX_TOL = 1e-2, 2e-2  # chip_smoke.py's bounds on each gradient


def ring_forms(items, sms, max_ctas, min_stages, max_stages, smem_of) -> dict:
    """{"ring c<ctas> s<stages>": (grid, stages)} of every ring that fits."""
    out = {}
    for ctas in range(1, max_ctas + 1):
        budget = min(lab.MAX_SMEM, lab.SM_SMEM // ctas - lab.CTA_RESERVED_SMEM)
        for stages in range(min_stages, max_stages + 1):
            if smem_of(stages) <= budget:
                out[f"ring c{ctas} s{stages}"] = (min(items, sms * ctas), stages)
    return out


def label(plan) -> str:
    return "cta" if plan.form == "cta" else f"ring c{plan.ctas_per_sm} s{plan.stages}"


def bwd_forms(B, L, H, D, sms) -> dict:
    """The lab backward's forms: "cta", and the ring (one CTA an SM) with
    each count of resident items that fits, where the ring takes the row."""
    forms = {"cta": (0, 0)}
    if D == 64 and L <= lab.BWD_RING_MAX_LEN:
        for stages in range(1, lab.BWD_RING_MAX_STAGES + 1):
            if lab.lab_bwd_smem_bytes(L, stages) <= lab.MAX_SMEM:
                forms[f"ring c1 s{stages}"] = (min(B * H, sms), stages)
    return forms


def pv_forms(B, L, H, D, sms) -> dict:
    """The P V's forms: "cta", and the ring at every count of CTAs an SM
    (two at head_dim 64 only) and every stage count that fits."""
    return {"cta": (0, 0), **ring_forms(B, sms, 2 if D == 64 else 1, lab.PV_MIN_STAGES, lab.PV_MAX_STAGES,
                                        lambda s: lab.lab_pv_smem_bytes(L, H * D, s))}


def _draw(gen, shape, std=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * std).to(torch.bfloat16)


def sweep_fwd(B, L, H, D, timer, gen, sms) -> dict:
    q, k = (_draw(gen, (B, L, H * D), 0.3) for _ in range(2))
    v = _draw(gen, (B, L, H * D))
    o = torch.empty_like(q)
    lse = torch.empty(B, H, L, device="cuda")
    ref_o, ref_lse = lab.lab_fwd_packed_plain(q, k, v, H)
    kernel = lab._kernel("latteclip_lab_fwd_packed")
    stream = torch.cuda.current_stream().cuda_stream
    run = lambda g, s: kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),  # noqa: E731
                              lse.data_ptr(), B, L, H, D, D ** -0.5, g, s, stream)
    forms = {"cta": (0, 0)}
    if L <= lab.FWD_RING_MAX_LEN:
        forms.update(ring_forms(B * H, sms, lab.fwd_max_ctas(L, D), 1, lab.RING_MAX_STAGES,
                                lambda s: lab.lab_fwd_smem_bytes(L, D, s)))
    times = {}
    for name, (grid, stages) in forms.items():
        if run(grid, stages):
            raise RuntimeError(f"lab forward form {name} refused at {(B, L, H, D)}")
        torch.cuda.synchronize()
        if not agrees(o, lse, ref_o, ref_lse):
            raise RuntimeError(f"lab forward form {name} disagrees at {(B, L, H, D)}")
        times[name] = timer(lambda: run(grid, stages))
    qb, kb, vb = (lab.to_bhld(x, H) for x in (q, k, v))
    own = label(lab.lab_fwd_plan(B, L, H, D, sms))
    return {"fwd": [B, L, H, D], "plan": own, "plan_ms": times[own], "best": min(times, key=times.get),
            "best_ms": min(times.values()),
            "sdpa_ms": timer(lambda: F.scaled_dot_product_attention(qb, kb, vb)), "ms": times}


def sweep_qk(B, L, H, D, timer, gen, sms) -> dict:
    HD = H * D
    q, k = (_draw(gen, (B, L, HD)) for _ in range(2))
    kt = k.transpose(1, 2).contiguous()
    s_out = torch.empty(B, L, L, device="cuda")
    ref = lab.qk_heads_natural_plain(q, k, H)
    kernel = lab._kernel("latteclip_lab_qk_pret")
    stream = torch.cuda.current_stream().cuda_stream
    run = lambda g, s: kernel(q.data_ptr(), kt.data_ptr(), s_out.data_ptr(), B, L, HD, g, s,  # noqa: E731
                              stream)
    forms = {"cta": (0, 0), **ring_forms(B, sms, 2, lab.QK_MIN_STAGES, lab.QK_MAX_STAGES,
                                         lambda s: lab.lab_qk_smem_bytes(L, s))}
    times = {}
    for name, (grid, stages) in forms.items():
        if run(grid, stages):
            raise RuntimeError(f"Q K^T form {name} refused at {(B, L, H, D)}")
        torch.cuda.synchronize()
        d = s_out - ref
        if max(float(d.norm() / ref.norm()), float(d.abs().max() / ref.abs().max())) > F32_REL_TOL:
            raise RuntimeError(f"Q K^T form {name} disagrees at {(B, L, H, D)}")
        times[name] = timer(lambda: run(grid, stages))
    own = label(lab.lab_qk_plan(B, L, HD, sms))
    return {"qk_pret": [B, L, H, D], "plan": own, "plan_ms": times[own], "best": min(times, key=times.get),
            "best_ms": min(times.values()), "bmm_ms": timer(lambda: torch.bmm(q, kt)), "ms": times}


def sweep_bwd(B, L, H, D, timer, gen, sms) -> dict:
    q, k = (_draw(gen, (B, H, L, D), 0.3) for _ in range(2))
    v, do = (_draw(gen, (B, H, L, D)) for _ in range(2))
    _, lse = lab.lab_fwd_bhld_plain(q, k, v)
    ref = lab.lab_bwd_bhld_plain(q, k, v, do, lse)
    grads = [torch.empty_like(q) for _ in range(3)]
    kernel = lab._kernel("latteclip_lab_bwd_bhld")
    stream = torch.cuda.current_stream().cuda_stream
    run = lambda g, s: kernel(*(x.data_ptr() for x in (q, k, v, do, lse, *grads)),  # noqa: E731
                              B, L, H, D, D ** -0.5, g, s, stream)
    times = {}
    for name, (grid, stages) in bwd_forms(B, L, H, D, sms).items():
        if run(grid, stages):
            raise RuntimeError(f"lab backward form {name} refused at {(B, L, H, D)}")
        torch.cuda.synchronize()
        for a, r in zip(grads, ref):
            d, r = a.float() - r.float(), r.float()
            if float(d.norm() / r.norm()) > GRAD_REL_TOL or float(d.abs().max() / r.abs().max()) > GRAD_MAX_TOL:
                raise RuntimeError(f"lab backward form {name} disagrees at {(B, L, H, D)}")
        times[name] = timer(lambda: run(grid, stages))
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    o = torch.nn.functional.scaled_dot_product_attention(*leaves)
    own = label(lab.lab_bwd_plan(B, L, H, D, sms))
    return {"bwd": [B, L, H, D], "plan": own, "plan_ms": times[own], "best": min(times, key=times.get),
            "best_ms": min(times.values()),
            "sdpa_bwd_ms": timer(lambda: torch.autograd.grad(o, leaves, do, retain_graph=True)), "ms": times}


def sweep_pv(B, L, H, D, timer, gen, sms) -> dict:
    p, v = _draw(gen, (B, L, L)), _draw(gen, (B, L, H * D))
    out = torch.empty(B, L, D, device="cuda")
    ref = lab.pv_heads_plain(p, v, H)
    kernel = lab._kernel("latteclip_lab_pv")
    stream = torch.cuda.current_stream().cuda_stream
    run = lambda g, s: kernel(p.data_ptr(), v.data_ptr(), out.data_ptr(), B, L, H, D, g, s,  # noqa: E731
                              stream)
    times = {}
    for name, (grid, stages) in pv_forms(B, L, H, D, sms).items():
        if run(grid, stages):
            raise RuntimeError(f"P V form {name} refused at {(B, L, H, D)}")
        torch.cuda.synchronize()
        d = out - ref
        if max(float(d.norm() / ref.norm()), float(d.abs().max() / ref.abs().max())) > F32_REL_TOL:
            raise RuntimeError(f"P V form {name} disagrees at {(B, L, H, D)}")
        times[name] = timer(lambda: run(grid, stages))
    vh = v.view(B, L, H, D)
    own = label(lab.lab_pv_plan(B, L, H, D, sms))
    return {"pv": [B, L, H, D], "plan": own, "plan_ms": times[own], "best": min(times, key=times.get),
            "best_ms": min(times.values()), "bmm_ms": timer(lambda: torch.bmm(p, v)),
            "einsum_ms": timer(lambda: torch.einsum("blm,bmhd->bld", p, vh)), "ms": times}


def run(fwd_shapes=FWD_SHAPES, qk_shapes=QK_SHAPES, bwd_shapes=BWD_SHAPES, pv_shapes=PV_SHAPES, iters=20):
    if not torch.cuda.is_available():
        raise RuntimeError("the lab kernels run on a CUDA device only")
    timer = Timer("cuda", iters=iters)
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for shape in fwd_shapes:
        yield sweep_fwd(*shape, timer, gen, sms)
    for shape in qk_shapes:
        yield sweep_qk(*shape, timer, gen, sms)
    for shape in bwd_shapes:
        yield sweep_bwd(*shape, timer, gen, sms)
    for shape in pv_shapes:
        yield sweep_pv(*shape, timer, gen, sms)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    for rec in run(iters=args.iters):
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
