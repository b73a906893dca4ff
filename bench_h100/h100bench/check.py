"""How ``correct`` is decided: the served tokens against the plain reference.

After the window, with the program's state freed, a sample of the requests
the window's engine finished is drawn from the seed, the one with the most
served tokens always in it. The reference (bench_h100/reference/<family>.py,
float32, TF32 off) runs once over each prompt with its served tokens, and
the reading is the widest gap by which a served token's logit lies below the
reference's best at its position (the banned ids left out of both). Every
token is greedy, so a sound program reads small gaps (near ties flipped by
its rounding) and a wrong one reads gaps of the logits' own spread.

The control (``--control 1``, never in the benchmark's own runs) is the
same reference computed in float8 (``fp8=True``), put in the program's
place: at each position of the same prompts and tokens, the gap of the
token it puts first, judged as the program's would be, so that a control
run reads ``correct`` false.
"""

from __future__ import annotations

import importlib

import torch

from .weights import BANNED


def sample(recs, rng, min_tokens: int, max_requests: int) -> list:
    """Finished requests to compare: the one with the most served tokens,
    then others in an order drawn from ``rng`` until ``min_tokens`` tokens
    or ``max_requests`` requests."""
    done = [r for r in recs if r.reason == "length" and r.tokens]
    if not done:
        return []
    first = max(done, key=lambda r: (len(r.tokens), -r.req.index))
    rest = [r for r in done if r is not first]
    picked, n = [first], len(first.tokens)
    for i in rng.permutation(len(rest)):
        if n >= min_tokens or len(picked) >= max_requests:
            break
        picked.append(rest[i])
        n += len(rest[i].tokens)
    return picked


def reference_model(cfg: dict, tensors, device):
    """The family's plain model over float32 weights dequantized from the
    same bytes the program loaded."""
    from reference.ggml_blocks import dequantize

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w = {t.name: dequantize(torch.from_numpy(t.data).to(device), t.fmt,
                            t.shape) for t in tensors}
    fam = importlib.import_module(f"reference.{cfg['family']}")
    return fam.Model(cfg, w)


@torch.no_grad()
def gaps(model, recs, control: bool = False) -> list[torch.Tensor]:
    """Per request, the gap (reference logits) of each served token, or with
    ``control`` of each token the float8 reference puts first."""
    out = []
    for r in recs:
        ids = r.req.ids + r.tokens[:-1]
        ref = model.logits(ids, len(r.req.ids) - 1)
        ref[:, list(BANNED)] = float("-inf")
        best = ref.max(1).values
        if control:
            ctl = model.logits(ids, len(r.req.ids) - 1, fp8=True)
            ctl[:, list(BANNED)] = float("-inf")
            pick = ctl.argmax(1)
        else:
            pick = torch.tensor(r.tokens, device=ref.device)
        got = ref.gather(1, pick[:, None])[:, 0]
        out.append((best - got).cpu())
    return out


def readings(per_request: list[torch.Tensor]) -> dict[str, float]:
    """The mean gap over every compared token (compared against a limit);
    the widest (reported only: a near tie of the router flips an expert at
    some positions of a sound run as of the control, and such a flip moves
    that position's logits by their own spread, so the widest gaps of the
    two overlap; how often it happens is what the precision sets); and the
    largest of the requests' own mean gaps (reported only, until sound runs
    and the control have been read on it at the cells' sizes)."""
    if not per_request:
        return dict.fromkeys(("mean_gap", "widest_gap", "worst_request_gap"),
                             float("inf"))
    g = torch.cat(per_request)
    return {"mean_gap": float(g.mean()), "widest_gap": float(g.max()),
            "worst_request_gap": max(float(r.mean()) for r in per_request)}
