"""K4's compaction cases, shared by the CPU tests
(``tests/test_torch_row_plan.py``, against the JAX package) and the card's
(``tests/test_torch_gpu.py``, against the plain version). Numpy only: the
card's test run imports it without JAX or a conftest."""

import numpy as np

PS, LAYERS = 64, 2


def _path(rng, Q, n):
    """An accepted path of n edges in a Q-wide tree verify: increasing node
    offsets in [1, Q), zero-padded to Q - 1."""
    p = np.zeros(Q - 1, np.int32)
    p[:n] = np.sort(rng.choice(np.arange(1, Q), size=n, replace=False))
    return p


def compact_case(kind, seed=0, widths=(16, 16)):
    """Arenas K [L, n_pages, PS, kw] and V [.., vw] of random rows and a
    verify step's (page_tables, ctx_lens, path, n_edges, Q, active), numpy:
    the compaction cases of K4's entry (``tests/test_torch_row_plan.py``
    holds them against the JAX package on the CPU). In each, at most one
    request's window names the null page 0."""
    rng = np.random.default_rng(seed)
    (kw, vw), P, Q, act = widths, 6, 17, None
    if kind == "identity":  # one branch: the accepted path is the draft's prefix
        ctx, paths = [100, 37], [np.arange(1, 17), np.arange(1, 17)]
        ne = [16, 5]
    elif kind == "r2l8":  # two branches of 8, the second accepted
        ctx, ne = [5, 30, 62], [3, 8, 2]
        paths = [1 + b * 8 + np.arange(8) for b in (1, 1, 0)]
    elif kind == "q64":  # the generator's width
        Q, ctx, ne = 64, [64, 90], [40, 63]
        paths = [_path(rng, Q, 40), np.arange(1, 64)]  # all 63 accepted: the identity
    elif kind == "q128":  # three window pages
        Q, P, ctx, ne = 128, 5, [70], [100]
        paths = [_path(rng, Q, 100)]
    elif kind == "straddle":  # windows from a page's last slot, and its first
        ctx, ne = [63, 128], [12, 16]
        paths = [_path(rng, Q, n) for n in ne]
    elif kind == "clip":  # the window passes the table's end: both slots name one page
        P, ctx, ne = 3, [180, 130], [14, 9]
        paths = [_path(rng, Q, n) for n in ne]
    elif kind == "inactive":  # the middle request is padding: its window is page 0
        ctx, ne, act = [20, 40, 75], [6, 7, 9], [True, False, True]
        paths = [_path(rng, Q, n) for n in ne]
    elif kind == "no_edges":  # nothing accepted, and a prefix path
        ctx, ne = [10, 200], [0, 5]
        paths = [_path(rng, Q, 9), np.arange(1, 6)]
    elif kind == "mla":  # unequal K and V rows, as MLA's latent 576 and 512 lanes
        kw, vw, ctx, ne = kw + kw // 8, kw, [33, 64], [7, 4]
        paths = [_path(rng, Q, n) for n in ne]
    else:
        raise ValueError(kind)
    B = len(ctx)
    n_pages = B * P + 1
    pt = (rng.permutation(n_pages - 1)[: B * P] + 1).reshape(B, P).astype(np.int32)
    path = np.zeros((B, Q - 1), np.int32)
    for b, p in enumerate(paths):
        path[b, : len(p)] = p
    k = rng.normal(size=(LAYERS, n_pages, PS, kw)).astype(np.float32)
    v = rng.normal(size=(LAYERS, n_pages, PS, vw)).astype(np.float32)
    active = np.ones(B, bool) if act is None else np.array(act)
    return dict(k=k, v=v, pt=pt, ctx=np.array(ctx, np.int32), path=path,
                ne=np.array(ne, np.int32), Q=Q, active=active)


CASES = ["identity", "r2l8", "q64", "q128", "straddle", "clip", "inactive", "no_edges",
         "mla"]
