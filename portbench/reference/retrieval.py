"""The person-search gallery and its plain reference scan.

The gallery is made from the seed in blocks of ``BLOCK`` rows: row
vectors of |N(0, 1)| entries, L2-normalised (non-negative and unit length,
as the model's embeddings are).  The reference stores each row as int8 on
its own (per-row symmetric scale ``absmax / 127``, round half to even),
and scans the dequantized rows exactly in float64.
"""

import torch

BLOCK = 65536


def gallery_block(b, dim, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed + b)
    x = torch.randn((BLOCK, dim), generator=gen, device=device).abs_()
    return x / x.norm(dim=1, keepdim=True)


def gallery(n, dim, seed, device, group=4):
    """The float gallery's rows in groups of ``group`` blocks."""
    for b in range(0, n // BLOCK, group):
        yield torch.cat([gallery_block(b + j, dim, seed, device)
                         for j in range(min(group, n // BLOCK - b))])


def quantize(rows):
    scale = torch.clamp(rows.abs().amax(dim=1) / 127.0, min=1e-12)
    return torch.clamp(torch.round(rows / scale[:, None]), -127, 127), scale


@torch.no_grad()
def scan(q, n, dim, seed, device, k, served=None):
    """The exact top-k of query rows ``q`` [m, dim] over the reference's
    int8 gallery: (distances [m, k] ascending, indices [m, k], and the
    distances of ``served`` indices [m, k'] when given), float64."""
    q = q.double()
    qq = (q * q).sum(1, keepdim=True)
    best_d = best_i = None
    got = None if served is None else torch.zeros(served.shape,
                                                 dtype=torch.float64,
                                                 device=device)
    for b in range(n // BLOCK):
        g8, s = quantize(gallery_block(b, dim, seed, device))
        g = g8.double() * s.double()[:, None]
        d = torch.sqrt(torch.clamp(qq + (g * g).sum(1)[None] - 2.0 * q @ g.T,
                                   min=0.0))
        idx = b * BLOCK + torch.arange(BLOCK, device=device)
        cd = d if best_d is None else torch.cat([best_d, d], 1)
        ci = idx.expand_as(d) if best_i is None else torch.cat(
            [best_i, idx.expand_as(d)], 1)
        best_d, pos = torch.topk(cd, k, dim=1, largest=False, sorted=True)
        best_i = torch.gather(ci, 1, pos)
        if served is not None:
            here = (served >= b * BLOCK) & (served < (b + 1) * BLOCK)
            local = torch.clamp(served - b * BLOCK, 0, BLOCK - 1).long()
            got = torch.where(here, torch.gather(d, 1, local), got)
    return best_d, best_i, got
