"""Next-token sampling and the speculative drafters (the port of
``sample_next_token``, ``NGramDrafter`` and ``TreeDrafter`` in
``mxtpu/models/sampler.py``).

Randomness comes from explicit ``torch.Generator``s.  A draw for one
row is a Gumbel-max draw from ``torch.rand(V, generator=g)``, taken row
by row, so a row drawn inside a pooled batch with its request's own
generator equals an isolated draw with a generator of the same seed.
The reference draws with JAX's threefry keys: sampled streams match
inside the port, never across the two frameworks.

Speculative verification needs "the k-th future draw, without
consuming it, then advance by m" (the reference's ``peek_key`` /
``advance``).  :func:`future_states` gets it from generator state
snapshots, each taken after a real draw on a scratch copy, so a peeked
draw is the very draw the stream would make there.
"""

from __future__ import annotations

import torch

__all__ = ["sample_next_token", "sampling_scores", "future_states",
           "generator_at", "NGramDrafter", "TreeDrafter"]

_NEG_INF = -1e30


def sample_next_token(logits, generator=None, temperature=1.0, top_k=0,
                      top_p=0.0, repetition_penalty=1.0, seen_mask=None,
                      active_mask=None):
    """Draw next-token ids from (B, V) logits; returns (B,) int64.

    temperature <= 0 is greedy (argmax, ties to the first index) and
    draws nothing.  Otherwise the logits are divided by the
    temperature, cut to the ``top_k`` highest (k > 0) and then to the
    smallest probability-sorted prefix whose mass reaches ``top_p``
    (0 < p < 1; the top token always stays), and one token is drawn
    per row.

    repetition_penalty != 1 with a (B, V) boolean ``seen_mask``: logits
    of tokens already seen are divided by the penalty where positive and
    multiplied where negative (the CTRL/HF convention), in greedy mode
    too.

    ``generator``: one ``torch.Generator`` (rows drawn in order from
    it) or a sequence of per-row generators (None for rows that draw
    nothing).  ``active_mask`` (B,) bool marks live pool rows: the rest
    return 0 and are kept out of the penalty."""
    out = torch.argmax(sampling_scores(
        logits, generator, temperature, top_k, top_p, repetition_penalty,
        seen_mask, active_mask), dim=-1)
    if active_mask is not None:
        out = torch.where(active_mask, out, torch.zeros_like(out))
    return out


def sampling_scores(logits, generator=None, temperature=1.0, top_k=0,
                    top_p=0.0, repetition_penalty=1.0, seen_mask=None,
                    active_mask=None):
    """The (B, V) float32 scores whose argmax :func:`sample_next_token`
    takes (same arguments): the penalized logits when greedy; the
    penalized, tempered and cut logits plus one Gumbel draw per row when
    sampling (the draw is taken from the generators)."""
    x = logits.float()
    if repetition_penalty and repetition_penalty != 1.0 \
            and seen_mask is not None:
        seen = seen_mask
        if active_mask is not None:
            seen = seen & active_mask.reshape(-1, 1)
        x = torch.where(seen, torch.where(x > 0, x / repetition_penalty,
                                          x * repetition_penalty), x)
    if not temperature or temperature <= 0.0:
        return x
    if temperature != 1.0:
        x = x / temperature
    neg = torch.full_like(x, _NEG_INF)
    if top_k and top_k > 0:
        kth = torch.topk(x, min(int(top_k), x.shape[-1]), dim=-1).values[
            ..., -1:]
        x = torch.where(x < kth, neg, x)
    if top_p and 0.0 < top_p < 1.0:
        sorted_x = torch.sort(x, dim=-1, descending=True).values
        probs = torch.softmax(sorted_x, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens while the mass BEFORE them is < top_p
        keep = (cum - probs) < top_p
        cutoff = torch.where(keep, sorted_x,
                             torch.full_like(sorted_x, float("inf"))).min(
            dim=-1, keepdim=True).values
        x = torch.where(x < cutoff, neg, x)
    B, V = x.shape
    gens = generator if isinstance(generator, (list, tuple)) \
        else [generator] * B
    noise = torch.zeros_like(x)
    drew = False
    for b, g in enumerate(gens):
        if g is None:
            continue
        u = _uniform(g, V, x.device)
        noise[b] = -torch.log(-torch.log(u.clamp_min(1e-20)))
        drew = True
    if not drew:
        raise ValueError("sample_next_token: temperature > 0 needs a "
                         "torch.Generator for every row that draws")
    return x + noise


def _uniform(generator, vocab, device):
    """One row's draw: ``vocab`` uniform float32 values."""
    return torch.rand(vocab, generator=generator, device=device,
                      dtype=torch.float32)


def future_states(generator, n, vocab, device):
    """The states of ``generator`` after 0, 1, ..., n more draws of
    ``vocab`` values (n + 1 states), without moving it: the draws are
    taken on a scratch generator set to its state, and each state is
    read after a real draw (a CUDA generator's offset advances by what a
    launch consumes, which is not computed here)."""
    states = [generator.get_state()]
    scratch = generator_at(states[0], device)
    for _ in range(n):
        _uniform(scratch, vocab, device)
        states.append(scratch.get_state())
    return states


def generator_at(state, device):
    """A new generator on ``device`` in ``state``."""
    g = torch.Generator(device=device)
    g.set_state(state)
    return g


class NGramDrafter:
    """Host-side self-drafter for speculative decoding: n-gram /
    prompt-lookup proposals (no draft model, no extra weights).

    ``propose`` finds the MOST RECENT prior occurrence of the longest
    trailing n-gram (``max_ngram`` down to ``min_ngram``) of a request's
    history (prompt + emitted tokens) and proposes the tokens that
    followed it.  A pure function of (history, k); proposals are copied
    from the history, so they are valid token ids.  The caller clamps
    ``k`` to its cache extent."""

    def __init__(self, max_ngram=3, min_ngram=1):
        if min_ngram < 1 or max_ngram < min_ngram:
            raise ValueError(
                "NGramDrafter needs 1 <= min_ngram <= max_ngram, got "
                "min=%d max=%d" % (min_ngram, max_ngram))
        self._max = int(max_ngram)
        self._min = int(min_ngram)

    def propose(self, history, k):
        """Up to ``k`` drafted continuation tokens of ``history`` (a 1-D
        int sequence), or ``[]`` when k <= 0 or no prior n-gram match
        exists.  Longest trailing n-gram wins; among equal lengths, the
        most recent occurrence."""
        k = int(k)
        H = [int(t) for t in history]
        L = len(H)
        if k <= 0 or L < 2:
            return []
        for n in range(min(self._max, L - 1), self._min - 1, -1):
            pat = H[L - n:]
            # most recent occurrence strictly before the trailing one
            for i in range(L - n - 1, -1, -1):
                if H[i:i + n] == pat:
                    return H[i + n:i + n + k]
        return []


class TreeDrafter:
    """Multi-branch host-side self-drafter for tree speculative
    decoding: the primary chain from the most recent occurrence of the
    longest trailing n-gram, plus alternate continuations from the
    next-most-recent occurrences, each grafted where it diverges from
    the tree built so far.

    A proposal is three equal-length lists ``(tokens, parent, depth)``
    over draft nodes: node j rides window lane j + 1 (lane 0 is the
    committed root token the engine prepends), ``parent[j]`` is the
    window lane of its parent (< j + 1, so lane order is topological)
    and ``depth[j] >= 1`` its depth.  Sibling tokens are unique (an
    alternate that agrees with an existing node follows it), so at most
    one root-to-leaf path can match the target's draws.  A pure function
    of (history, budgets); ``branch`` caps the children of any node."""

    def __init__(self, max_nodes=8, branch=2, max_ngram=3, min_ngram=1):
        if min_ngram < 1 or max_ngram < min_ngram:
            raise ValueError(
                "TreeDrafter needs 1 <= min_ngram <= max_ngram, got "
                "min=%d max=%d" % (min_ngram, max_ngram))
        if max_nodes < 1 or branch < 1:
            raise ValueError(
                "TreeDrafter needs max_nodes >= 1 and branch >= 1, "
                "got nodes=%d branch=%d" % (max_nodes, branch))
        self._nodes = int(max_nodes)
        self._branch = int(branch)
        self._max = int(max_ngram)
        self._min = int(min_ngram)

    @property
    def max_nodes(self):
        return self._nodes

    @property
    def branch(self):
        return self._branch

    def propose_tree(self, history, max_nodes, max_depth):
        """Draft a tree continuing ``history``: ``(tokens, parent,
        depth)`` lists (possibly empty) of at most min(max_nodes,
        self.max_nodes) nodes, depths <= max_depth.  The occurrences of
        the longest trailing n-gram are walked most recent first: the
        first builds the primary chain, later ones graft branches at
        their divergence points until the node budget or the branch cap
        stops them."""
        max_nodes = min(int(max_nodes), self._nodes)
        max_depth = int(max_depth)
        H = [int(t) for t in history]
        L = len(H)
        if max_nodes <= 0 or max_depth <= 0 or L < 2:
            return [], [], []
        starts = []
        for n in range(min(self._max, L - 1), self._min - 1, -1):
            pat = H[L - n:]
            starts = [i + n for i in range(L - n - 1, -1, -1)
                      if H[i:i + n] == pat]
            if starts:
                break
        if not starts:
            return [], [], []

        toks, parents, depths = [], [], []
        children = {0: {}}            # window lane -> {token: child lane}

        def _insert(chain):
            lane, d = 0, 0
            for tok in chain:
                if d >= max_depth:
                    return
                kids = children.setdefault(lane, {})
                if tok in kids:       # sibling dedup: follow, don't fork
                    lane = kids[tok]
                    d += 1
                    continue
                if len(kids) >= self._branch or len(toks) >= max_nodes:
                    return
                toks.append(tok)
                parents.append(lane)
                depths.append(d + 1)
                lane = kids[tok] = len(toks)   # window lane (root = 0)
                d += 1

        for s in starts:
            if len(toks) >= max_nodes:
                break
            _insert(H[s:s + max_depth])
        return toks, parents, depths
