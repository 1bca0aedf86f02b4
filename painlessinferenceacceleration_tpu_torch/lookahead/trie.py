"""Trie-tree draft cache (host side).

The port's own copy of ``painlessinferenceacceleration_tpu/lookahead/trie.py``
(pure Python and numpy), a semantics-compatible rebuild of the reference's
LookaheadCache / Tree (lookahead/common/lookahead_cache.py): per-start-token
tries of n-grams with two frequency channels per node — per-request "input"
freqs (keyed by request idx, from prompt tokens) and a global "output" freq
(key -1, from generated tokens). Retrieval does a frequency-thresholded DFS
that ravels the hottest subtree into (ids, ancestor-matrix mask, parents),
which the verify step consumes directly.

Differences from the reference (deliberate):
- the ravel also emits a ``parents`` array (the acceptance walk wants
  parent pointers, not just the mask — engine/step.py ``_accept_walk``),
- masks are plain numpy int64; padding to the fixed verify width happens in
  lookahead/generate.py.

Eviction follows the reference's law: when a trie exceeds max_node /
max_output_node, halve output freqs and drop nodes whose freq falls <= 1
(lookahead_cache.py:295-318 squeeze).
"""

from __future__ import annotations

import json
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class _Node:
    __slots__ = ("kids", "out_freq", "in_freqs")

    def __init__(self):
        self.kids: Dict[int, _Node] = {}
        self.out_freq: float = 0.0
        self.in_freqs: Dict[int, float] = {}

    def freq_in(self, idx: int) -> float:
        return self.in_freqs.get(idx, 0.0)


class TokenTrie:
    """All n-grams observed after one start token (reference: Tree)."""

    def __init__(self, token_id: int, max_node: int = 65536, max_output_node: int = 512):
        self.token_id = token_id
        self.max_node = max_node
        self.max_output_node = max_output_node
        self.n_node = 0
        self.n_output_node = 0
        self.root: Dict[int, _Node] = {}

    # -- insertion ---------------------------------------------------------

    def put(self, token_ids: Sequence[int], mode: str = "output", idx: int = 0,
            freq: float = 1.0) -> None:
        """Insert one n-gram, bumping freqs along the existing prefix."""
        nodes = self.root
        fresh = 0
        for pos, tok in enumerate(token_ids):
            node = nodes.get(tok)
            if node is None:
                node = _Node()
                nodes[tok] = node
                fresh += 1
            if mode == "output":
                node.out_freq += freq
            else:
                node.in_freqs[idx] = node.in_freqs.get(idx, 0.0) + freq
            nodes = node.kids
        self.n_node += fresh
        if mode == "output":
            self.n_output_node += fresh

    # -- retrieval ---------------------------------------------------------

    def _walk(self, token_ids: Sequence[int], mode: str, idx: int):
        """Follow the query suffix through freq-positive nodes; return the
        last consumed token and the children dict where drafting starts."""
        nodes = self.root
        last = None
        for tok in token_ids:
            last = tok
            node = nodes.get(tok)
            nodes = {}
            if node is None:
                break
            alive = (
                node.freq_in(idx) > 0 if mode == "input"
                else node.out_freq > 0 if mode == "output"
                else node.freq_in(idx) > 0 or node.out_freq > 0
            )
            if alive:
                nodes = node.kids
        return last, nodes

    def _collect_freqs(self, nodes: Dict[int, _Node], idx: int, w_out: float):
        """Flatten (input, output, mixed) freqs of all live nodes (DFS)."""
        out: List[Tuple[float, float, float]] = []
        stack = [nodes]
        while stack:
            for node in stack.pop().values():
                fi, fo = node.freq_in(idx), node.out_freq
                if fi > 0 or fo > 0:
                    out.append((fi, fo, (1.0 - w_out) * fi + w_out * fo))
                    if node.kids:
                        stack.append(node.kids)
        return out

    def _thresholds(self, freqs, max_size, min_input_size, min_output_size,
                    mode: str, w_out: float):
        """Pick per-channel minimum freqs so that roughly max_size nodes pass.

        Mirrors the reference's budget logic (lookahead_cache.py:89-131):
        guarantee min_input_size / min_output_size winners per channel, fill
        the rest by mixed frequency."""
        BIG = 1e9
        min_in = min_out = min_mix = BIG
        if mode == "input":
            live = sum(1 for f in freqs if f[0] > 0)
            if live > max_size:
                ranked = sorted((f[0] for f in freqs), reverse=True)
                min_in = ranked[max(min_input_size - 1, 0)]
            else:
                min_in = 0.0
        elif mode == "output":
            live = sum(1 for f in freqs if f[1] > 0)
            if live > max_size:
                ranked = sorted((f[1] for f in freqs), reverse=True)
                min_out = ranked[max(min_output_size - 1, 0)]
            else:
                min_out = 0.0
        else:
            live = sum(1 for f in freqs if f[0] > 0 or f[1] > 0)
            if live > max_size:
                chosen = set()
                if min_input_size > 0:
                    by_in = sorted(enumerate(freqs), key=lambda x: x[1][0], reverse=True)
                    min_in = by_in[min_input_size - 1][1][0]
                    chosen.update(i for i, _ in by_in[:min_input_size])
                if min_output_size > 0:
                    by_out = sorted(enumerate(freqs), key=lambda x: x[1][1], reverse=True)
                    min_out = by_out[min_output_size - 1][1][1]
                    chosen.update(i for i, _ in by_out[:min_output_size])
                if len(chosen) < max_size:
                    by_mix = sorted(enumerate(freqs), key=lambda x: x[1][2], reverse=True)
                    rest = max_size - len(chosen)
                    chosen.update(i for i, _ in by_mix[:rest])
                    n = len(chosen)
                    for i in range(rest, min(rest + max_size, live)):
                        if by_mix[i][0] in chosen:
                            continue
                        n += 1
                        if n >= max_size:
                            min_mix = by_mix[i][1][2]
                            break
            else:
                min_mix = 0.0
        return min_in, min_out, min_mix

    def get(self, token_ids: Sequence[int], max_size: int = 64, max_length: int = 8,
            min_input_size: int = 0, min_output_size: int = 0,
            output_weight: float = 1e-4, mode: str = "mix", idx: int = 0):
        """Hierarchical multi-branch draft.

        Returns (ids, mask, parents, sizes): ids[0] is the root (last matched
        token), mask is the [n, n] int64 ancestor matrix (row t = nodes
        visible to node t, col 0 all ones), parents[t] is the in-step parent
        index (-1 for root), sizes = [n_input_hits, n_output_hits].
        """
        assert mode in ("input", "output", "mix")
        last, nodes = self._walk(token_ids, mode, idx)
        root = last if last is not None else self.token_id
        if not nodes:
            return [root], np.ones((1, 1), np.int64), [-1], [0, 0]

        w_out = 0.0 if mode == "input" else 1.0 if mode == "output" else output_weight
        freqs = self._collect_freqs(nodes, idx, output_weight)
        min_in, min_out, min_mix = self._thresholds(
            freqs, max_size, min_input_size, min_output_size, mode, w_out
        )

        ids = [root]
        parents = [-1]
        mask = np.zeros((max_size, max_size), np.int64)
        mask[:, 0] = 1
        sizes = [0, 0]

        # pre-order DFS, hottest child first, a child's subtree fully raveled
        # before its next sibling — so the size budget prefers deepening the
        # hottest branch (recursion depth is bounded by max_length)
        def expand(kids: Dict[int, _Node], pid: int, depth: int) -> None:
            if depth <= 0 or len(ids) >= max_size:
                return
            ranked = sorted(
                kids.items(),
                key=lambda kv: (1.0 - w_out) * kv[1].freq_in(idx)
                + w_out * kv[1].out_freq,
                reverse=True,
            )
            for tok, node in ranked:
                if len(ids) >= max_size:
                    return
                fi, fo = node.freq_in(idx), node.out_freq
                fm = (1.0 - w_out) * fi + w_out * fo
                if mode == "mix":
                    if fi <= 0 and fo <= 0:
                        continue
                    if fi < min_in and fo < min_out and fm < min_mix:
                        continue
                elif mode == "input":
                    if fi <= 0 or fi < min_in:
                        continue
                else:
                    if fo <= 0 or fo < min_out:
                        continue
                if fi > 0:
                    sizes[0] += 1
                if fo > 0:
                    sizes[1] += 1
                rid = len(ids)
                ids.append(tok)
                parents.append(pid)
                mask[rid] = mask[pid]
                mask[rid, rid] = 1
                if node.kids:
                    expand(node.kids, rid, depth - 1)

        expand(nodes, 0, max_length)
        n = len(ids)
        return ids, mask[:n, :n], parents, sizes

    def get_one_branch(self, token_ids: Sequence[int], max_length: int = 8,
                       mode: str = "mix", idx: int = 0):
        """Single hottest branch (reference: get_one_branch,
        lookahead_cache.py:171-222; mixed score = 10000*f_in + f_out)."""
        last, nodes = self._walk(token_ids, mode, idx)
        root = last if last is not None else self.token_id
        if not nodes:
            return [root], np.ones((1, 1), np.int64), [-1], [0, 0]
        ids = [root]
        depth = 0
        while nodes and depth < max_length:
            best, best_tok = None, None
            best_f = 0.0
            for tok, node in nodes.items():
                fi, fo = node.freq_in(idx), node.out_freq
                if mode == "input":
                    f = fi if fi > 0 else 0.0
                elif mode == "output":
                    f = fo if fo > 0 else 0.0
                else:
                    f = 10000.0 * fi + fo if (fi > 0 or fo > 0) else 0.0
                if f > best_f:
                    best_f, best, best_tok = f, node, tok
            if best is None:
                break
            ids.append(best_tok)
            nodes = best.kids
            depth += 1
        n = depth + 1
        mask = np.tril(np.ones((n, n), np.int64))
        parents = list(range(-1, n - 1))
        return ids, mask, parents, [depth]

    # -- maintenance ---------------------------------------------------------

    def squeeze(self) -> None:
        """Decay-and-evict when over budget (reference freq law: halve output
        freqs > 1, drop nodes at <= 1 — lookahead_cache.py:295-312)."""
        if self.n_node <= self.max_node and self.n_output_node <= self.max_output_node:
            return
        stack = [self.root]
        while stack:
            nodes = stack.pop()
            for tok in list(nodes.keys()):
                node = nodes[tok]
                if node.out_freq > 1.0:
                    node.out_freq *= 0.5
                    if node.kids:
                        stack.append(node.kids)
                else:
                    del nodes[tok]
        self.n_node = self.n_output_node = self._count()

    def _count(self) -> int:
        n = 0
        stack = [self.root]
        while stack:
            nodes = stack.pop()
            n += len(nodes)
            stack.extend(node.kids for node in nodes.values() if node.kids)
        return n

    def reset_input_freq(self, idx: int) -> None:
        stack = [self.root]
        while stack:
            for node in stack.pop().values():
                if node.in_freqs.get(idx, 0.0) != 0.0:
                    node.in_freqs[idx] = 0.0
                    if node.kids:
                        stack.append(node.kids)


class DraftCache:
    """Facade over per-start-token tries (reference: LookaheadCache,
    lookahead_cache.py:336-587): eos truncation, n-gram insertion at every
    suffix position, retrieval modes hier/par/one/bat, persistence."""

    def __init__(self, eos_ids: Sequence[int] = (2,), stop_words=None,
                 max_node: int = 65536, max_output_node: int = 512,
                 squeeze_every: int = 1024):
        self.eos_ids = tuple(eos_ids) if eos_ids is not None else ()
        self.stop_words = set(stop_words or ())
        self.max_node = max_node
        self.max_output_node = max_output_node
        self.squeeze_every = squeeze_every
        self.mem: Dict[int, TokenTrie] = {}
        self._stream_buf: Dict[int, List[int]] = {}
        self._touched: set = set()
        self._touched_input: set = set()

    def _truncate_eos(self, token_ids: Sequence[int]) -> List[int]:
        ids = list(token_ids)
        for eos in self.eos_ids:
            if eos in ids:
                ids = ids[: ids.index(eos)]
        return ids

    def _tree(self, token_id: int) -> TokenTrie:
        tree = self.mem.get(token_id)
        if tree is None:
            tree = TokenTrie(token_id, self.max_node, self.max_output_node)
            self.mem[token_id] = tree
        return tree

    def put(self, token_ids: Sequence[int], branch_length: int = 8,
            final: bool = False, mode: str = "output", idx: int = 0) -> None:
        """Insert every suffix n-gram of token_ids (window branch_length)."""
        ids = self._truncate_eos(token_ids)
        if len(ids) >= 2:
            for i in range(len(ids) - 1):
                if ids[i] in self.stop_words:
                    continue
                tree = self._tree(ids[i])
                tree.put(ids[i + 1 : i + branch_length + 1], mode=mode, idx=idx)
                self._touched.add(ids[i])
                if mode == "input":
                    self._touched_input.add(ids[i])
        if final:
            self._finalize(idx)

    def stream_put(self, token_ids: Sequence[int], branch_length: int = 8,
                   final: bool = False, idx: int = 0) -> None:
        """Streaming insertion of generated tokens with a per-request tail
        buffer so overlapping n-grams are inserted exactly once."""
        buf = self._stream_buf.setdefault(idx, [])
        buf.extend(self._truncate_eos(token_ids))
        keep = 1 if final else branch_length
        if len(buf) > keep:
            for i in range(len(buf) - keep):
                if buf[i] in self.stop_words:
                    continue
                self._tree(buf[i]).put(
                    buf[i + 1 : i + branch_length + 1], mode="output", idx=idx
                )
                self._touched.add(buf[i])
            if not final:
                self._stream_buf[idx] = buf[len(buf) - branch_length :]
        if final:
            self._stream_buf[idx] = []
            self._finalize(idx)

    def _finalize(self, idx: int) -> None:
        for tok in self._touched_input:
            tree = self.mem.get(tok)
            if tree is not None:
                tree.reset_input_freq(idx)
        self._touched_input.clear()
        if len(self._touched) >= self.squeeze_every:
            for tok in self._touched:
                tree = self.mem.get(tok)
                if tree is not None:
                    tree.squeeze()
            self._touched.clear()

    # -- retrieval -----------------------------------------------------------

    def hier_get(self, token_ids: Sequence[int], decoding_length: int = 64,
                 branch_length: int = 8, min_input_size: int = 0,
                 min_output_size: int = 0, mode: str = "mix", idx: int = 0):
        """Multi-branch tree draft for the query suffix. Tries each start
        position; stops early once a draft of >= branch_length tokens found."""
        if decoding_length <= 1 or branch_length == 0:
            return list(token_ids[-1:]), np.ones((1, 1), np.int64), [-1], [0, 0]
        best = None
        for i, tok in enumerate(token_ids):
            tree = self.mem.get(tok)
            if tree is None:
                continue
            suffix = list(token_ids[i + 1 :])
            if tok in self.stop_words and not suffix:
                continue
            ids, mask, parents, sizes = tree.get(
                suffix,
                max_size=decoding_length,
                max_length=branch_length,
                min_input_size=min_input_size,
                min_output_size=min_output_size,
                mode=mode,
                idx=idx,
            )
            best = (ids, mask, parents, sizes)
            if len(ids) >= branch_length:
                break
        if best is None:
            return list(token_ids[-1:]), np.ones((1, 1), np.int64), [-1], [0, 0]
        return best

    def one_get(self, token_ids: Sequence[int], decoding_length: int = 64,
                branch_length: int = 8, min_input_size: int = 0,
                min_output_size: int = 0, mode: str = "mix", idx: int = 0):
        """Single-branch draft (reference one_get, lookahead_cache.py:490)."""
        if decoding_length <= 1 or branch_length == 0:
            return list(token_ids[-1:]), np.ones((1, 1), np.int64), [-1], [0, 0]
        best = None
        for i, tok in enumerate(token_ids):
            tree = self.mem.get(tok)
            if tree is None:
                continue
            suffix = list(token_ids[i + 1 :])
            if tok in self.stop_words and not suffix:
                continue
            ids, mask, parents, sizes = tree.get_one_branch(
                suffix, max_length=branch_length, mode=mode, idx=idx
            )
            best = (ids, mask, parents, sizes)
            if len(ids) >= max(branch_length // 2, 1):
                break
        if best is None:
            return list(token_ids[-1:]), np.ones((1, 1), np.int64), [-1], [0, 0]
        return best

    def par_get(self, token_ids: Sequence[int], decoding_length: int = 16,
                branch_length: int = 8, min_input_size: int = 0,
                min_output_size: int = 0, mode: str = "mix", idx: int = 0):
        """Flatten the hier tree into parallel independent branches
        (reference par_get, lookahead_cache.py:441-488)."""
        got = self.hier_get(
            token_ids, decoding_length=decoding_length, branch_length=branch_length,
            min_input_size=min_input_size, min_output_size=min_output_size,
            mode=mode, idx=idx,
        )
        return parallelize_draft(*got)

    def bat_get(self, token_id_list, decoding_length: int = 64,
                branch_length: int = 8, mode: str = "output",
                indices: Optional[Sequence[int]] = None,
                decoding_mode: str = "hier"):
        """Batched retrieval: per-request sub-budget decoding_length // bs
        (reference bat_get, lookahead_cache.py:519-561 +
        pretrained_model_batch.py:713). Returns per-request (ids, mask,
        parents, sizes) tuples; padding to a common width happens in the
        generator (static shapes)."""
        bs = len(token_id_list)
        indices = indices if indices is not None else list(range(bs))
        sub = max(decoding_length // max(bs, 1), 1)
        getter = self.hier_get if decoding_mode == "hier" else self.one_get
        out = []
        for q, idx in zip(token_id_list, indices):
            out.append(
                getter(
                    q,
                    decoding_length=sub,
                    branch_length=branch_length,
                    min_input_size=0,
                    min_output_size=max(sub // 2, 1),
                    mode=mode,
                    idx=idx,
                )
            )
        return out

    # -- persistence (reference save_mem/load_mem, lookahead_cache.py:578) ---

    def fresh(self) -> None:
        self.mem = {}

    def save_mem(self, path: str) -> None:
        blob = pickle.dumps(self.mem)
        with open(path, "w") as f:
            json.dump(blob.decode("latin-1"), f)

    def load_mem(self, path: str) -> None:
        with open(path) as f:
            self.mem = pickle.loads(json.load(f).encode("latin-1"))


def parallelize_draft(ids, mask, parents, sizes):
    """Flatten a hier draft into parallel independent branches: maximal
    root-to-leaf paths laid out sequentially, each causal within itself and
    blind to the others (reference par_get layout)."""
    n = len(ids)
    if n <= 1:
        return ids, mask, parents, sizes
    taken: List[set] = []
    for r in range(n - 1, 0, -1):
        anc = set(np.nonzero(mask[r, 1:])[0])
        if not any(anc <= t for t in taken):
            taken.append(anc)
    taken.reverse()
    budget = n - 1
    out_ids = [ids[0]]
    out_parents = [-1]
    count = 0
    branch_spans = []
    for anc in taken:
        cols = sorted(anc)[: budget - count]
        if not cols:
            break
        start = len(out_ids)
        for j, c in enumerate(cols):
            out_ids.append(ids[c + 1])
            out_parents.append(0 if j == 0 else start + j - 1)
        branch_spans.append((start, len(cols)))
        count += len(cols)
        if count >= budget:
            break
    m = len(out_ids)
    new_mask = np.zeros((m, m), np.int64)
    new_mask[:, 0] = 1
    for start, ln in branch_spans:
        for j in range(ln):
            r = start + j
            new_mask[r, start : r + 1] = 1
    return out_ids, new_mask, out_parents, [m - 1]
