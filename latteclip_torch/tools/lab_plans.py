"""Time the lab forward and the head-summed Q K^T under launch plans other
than their own, on the card:

    python -m latteclip_torch.tools.lab_plans

For each shape, the packed lab forward (``latteclip_lab_fwd_packed``) runs
under its one-CTA-per-(b, h) form and under the ring at every count of CTAs
an SM that its registers allow and every stage count that fits; the Q K^T
from kT (``latteclip_lab_qk_pret``) under its one-CTA-per-row form and under
the ring at one and two CTAs an SM and every stage count that fits. Each
form is checked against the plain version (out and lse, or S, as
``chip_smoke.py`` holds them) and timed with CUDA events, L2 flushed, median
of ``--iters``. One JSON line a shape: the plan that ``lab.lab_fwd_plan``
(or ``lab_qk_plan``) picks, its time, every form's time, and the library
call's (SDPA's forward, or ``torch.bmm``) on the same operands. It answers
how the plans' rules were chosen; the kernels and their wrappers never read
it.
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
F32_REL_TOL = 1e-4  # chip_smoke.py's bound on the head-summed products


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


def run(fwd_shapes=FWD_SHAPES, qk_shapes=QK_SHAPES, iters=20):
    if not torch.cuda.is_available():
        raise RuntimeError("the lab kernels run on a CUDA device only")
    timer = Timer("cuda", iters=iters)
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for shape in fwd_shapes:
        yield sweep_fwd(*shape, timer, gen, sms)
    for shape in qk_shapes:
        yield sweep_qk(*shape, timer, gen, sms)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    for rec in run(iters=args.iters):
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
