"""Next-token sampling, the speculative drafters and the sequence
samplers (the port of ``sample_next_token``, ``NGramDrafter``,
``TreeDrafter``, ``BeamSearchSampler``, ``beam_search`` and
``SequenceSampler`` in ``mxtpu/models/sampler.py``).

The sequence samplers run over the model's contiguous ``prefill`` and
``step``: one prefill at batch B, each sequence's caches tiled K times
(row b*K + k is continuation k of sequence b), then one step a token.
Beam search ranks in float64 on the host as the reference does, with
ties broken by the lower index (a stable sort), so ``beam_size=1`` is
greedy ``generate``.

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

import numpy as np
import torch

__all__ = ["sample_next_token", "sampling_scores", "future_states",
           "generator_at", "NGramDrafter", "TreeDrafter",
           "BeamSearchSampler", "beam_search", "SequenceSampler"]

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


def _tile(leaf, K):
    """A cache leaf (a tensor or an int8 pair) with each row repeated K
    times in place order."""
    if isinstance(leaf, tuple):
        return tuple(t.repeat_interleave(K, dim=0) for t in leaf)
    return leaf.repeat_interleave(K, dim=0)


def _take(leaf, idx):
    """A cache leaf's rows ``idx``, in that order."""
    if isinstance(leaf, tuple):
        return tuple(t.index_select(0, idx) for t in leaf)
    return leaf.index_select(0, idx)


def _prepare(model, prompt_ids, max_new_tokens, max_length, K):
    """The samplers' preamble: check the lengths, answer max_new_tokens
    <= 0 with the prompt K times, else prefill once at batch B and tile
    each sequence's caches K times.  Returns (done, early result,
    (prompt (B, Tp) int64 on the model's device, B, Tp, total, logits,
    caches))."""
    prompt = torch.as_tensor(prompt_ids, device=model.device).long()
    B, Tp = prompt.shape
    total = Tp + max_new_tokens
    max_length = max_length or total
    if max_length < total:
        raise ValueError("max_length %d < prompt+new %d"
                         % (max_length, total))
    if max_new_tokens <= 0:
        beams = prompt.cpu().int()[:, None, :].repeat(1, K, 1)
        return True, (beams, np.zeros((B, K))), None
    caches = model.init_cache(B, max_length)
    logits = model.prefill(prompt, caches)
    caches = [tuple(_tile(leaf, K) for leaf in pair) for pair in caches]
    return False, None, (prompt, B, Tp, total, logits, caches)


class BeamSearchSampler:
    """Length-normalized beam search (gluonnlp conventions), the
    reference's arithmetic: log-probabilities in float64 on the host,
    candidates ranked by score / ((5 + len) / 6) ** alpha per beam,
    raw scores kept.

    Parameters
    ----------
    model : a port ``TransformerLM`` (``init_cache`` / ``prefill`` /
        ``step``).
    beam_size : beams per sequence (K).
    alpha : the length penalty's exponent.
    eos_id : a token that ends a beam: a finished beam is frozen (its
        score stops growing) and padded with eos_id.
    """

    def __init__(self, model, beam_size=4, alpha=0.6, eos_id=None):
        self._model = model
        self._K = int(beam_size)
        self._alpha = float(alpha)
        self._eos = eos_id

    @staticmethod
    def _log_softmax(logits):
        x = logits.float().cpu().numpy().astype(np.float64)
        x = x - x.max(axis=-1, keepdims=True)
        return x - np.log(np.exp(x).sum(axis=-1, keepdims=True))

    def _penalty(self, length):
        return ((5.0 + length) / 6.0) ** self._alpha

    @staticmethod
    def _topk_desc(flat, k):
        """Indices of the k largest entries a row, descending, ties to
        the lower index."""
        return np.argsort(-flat, axis=-1, kind="stable")[:, :k]

    @torch.no_grad()
    def __call__(self, prompt_ids, max_new_tokens, max_length=None):
        """Returns (samples (B, K, Tp + new) int32 CPU tensor sorted by
        descending length-normalized score, scores (B, K) numpy array of
        the raw sequence log-probabilities)."""
        model = self._model
        K = self._K
        done, early, state = _prepare(model, prompt_ids, max_new_tokens,
                                      max_length, K)
        if done:
            return early
        prompt, B, Tp, total, logits, caches = state
        logp = self._log_softmax(logits[:, -1])                # (B, V)
        V = logp.shape[-1]
        if K > V:
            raise ValueError(
                "beam_size %d exceeds vocabulary size %d: beam search "
                "needs K distinct continuations per step" % (K, V))
        top = self._topk_desc(logp, K)                          # (B, K)
        scores = np.take_along_axis(logp, top, axis=-1)
        beams = np.repeat(prompt.cpu().numpy()[:, None, :], K, axis=1)
        beams = np.concatenate([beams, top[:, :, None]], axis=2)
        finished = np.zeros((B, K), bool)
        if self._eos is not None:
            finished |= top == self._eos
        lengths = np.ones((B, K))
        dev = model.device
        for pos in range(Tp, total - 1):
            tok = torch.from_numpy(beams[:, :, -1].reshape(B * K, 1)).to(dev)
            logits = model.step(tok, caches, pos)
            logp = self._log_softmax(logits[:, 0]).reshape(B, K, V)
            # frozen beams: only an eos continuation, at logprob 0
            if self._eos is not None and finished.any():
                frozen = np.full((B, K, V), _NEG_INF)
                frozen[:, :, self._eos] = 0.0
                logp = np.where(finished[:, :, None], frozen, logp)
            cand = scores[:, :, None] + logp                    # (B, K, V)
            cand_len = lengths + ~finished
            norm = cand / self._penalty(cand_len)[:, :, None]
            pick = self._topk_desc(norm.reshape(B, K * V), K)   # (B, K)
            src_beam, tok_next = pick // V, pick % V
            scores = np.take_along_axis(cand.reshape(B, K * V), pick, axis=-1)
            lengths = np.take_along_axis(cand_len, src_beam, axis=1)
            beams = np.concatenate(
                [np.take_along_axis(beams, src_beam[:, :, None], axis=1),
                 tok_next[:, :, None]], axis=2)
            if pos < total - 2:     # the last iteration's caches die unused
                gidx = torch.from_numpy(
                    (np.arange(B)[:, None] * K + src_beam).reshape(-1)).to(dev)
                caches = [tuple(_take(leaf, gidx) for leaf in pair)
                          for pair in caches]
            finished = np.take_along_axis(finished, src_beam, axis=1)
            if self._eos is not None:
                finished |= tok_next == self._eos
                if finished.all():
                    pad = np.full((B, K, total - beams.shape[2]), self._eos,
                                  beams.dtype)
                    beams = np.concatenate([beams, pad], axis=2)
                    break
        order = np.argsort(-scores / self._penalty(lengths), axis=-1,
                           kind="stable")
        beams = np.take_along_axis(beams, order[:, :, None], axis=1)
        scores = np.take_along_axis(scores, order, axis=-1)
        return torch.from_numpy(beams.astype(np.int32)), scores


def beam_search(model, prompt_ids, max_new_tokens, beam_size=4, alpha=0.6,
                eos_id=None, max_length=None):
    """Functional form of :class:`BeamSearchSampler`."""
    return BeamSearchSampler(model, beam_size, alpha, eos_id)(
        prompt_ids, max_new_tokens, max_length)


class SequenceSampler:
    """K independent sampled continuations a prompt (gluonnlp's
    SequenceSampler): each of the B*K rows draws its next token with
    :func:`sample_next_token` and sums its own log-probabilities; a row
    that drew ``eos_id`` freezes and pads.  Draws come from one
    ``torch.Generator`` seeded with ``seed`` (a random seed when None),
    rows in order, so a seed reproduces the samples inside the port, not
    the reference's draws.

    Returns (samples (B, K, Tp + new) int32 CPU tensor, scores (B, K)
    numpy array of the summed log-probabilities), rows sorted by
    descending score.
    """

    def __init__(self, model, n_samples=4, temperature=1.0, top_k=0,
                 top_p=0.0, repetition_penalty=1.0, eos_id=None):
        self._model = model
        self._K = int(n_samples)
        self._temp = float(temperature)
        self._top_k = top_k
        self._top_p = top_p
        self._rep = repetition_penalty
        self._eos = eos_id

    @torch.no_grad()
    def __call__(self, prompt_ids, max_new_tokens, max_length=None,
                 seed=None):
        model = self._model
        K = self._K
        done, early, state = _prepare(model, prompt_ids, max_new_tokens,
                                      max_length, K)
        if done:
            return early
        prompt, B, Tp, total, logits, caches = state
        dev = model.device
        gen = None
        if self._temp > 0.0:       # seeded after prefill, as generate
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed) if seed is not None
                            else int(np.random.randint(0, 2**31 - 1)))
        penalized = bool(self._rep and self._rep != 1.0)
        last = logits[:, -1].repeat_interleave(K, dim=0)        # (B*K, V)
        V = last.shape[-1]
        rows = torch.arange(B * K, device=dev)
        seen = None
        if penalized:
            seen = torch.zeros((B * K, V), dtype=torch.bool, device=dev)
            seen[rows[:, None], prompt.repeat_interleave(K, dim=0)] = True
        beams = np.repeat(prompt.cpu().numpy()[:, None, :], K, axis=1)
        scores = np.zeros((B, K))
        finished = np.zeros((B, K), bool)
        for pos in range(Tp, total):
            nxt = sample_next_token(last, gen, self._temp, self._top_k,
                                    self._top_p, self._rep, seen_mask=seen)
            logp = torch.log_softmax(last.float(), dim=-1)
            tok_logp = logp.gather(1, nxt[:, None])[:, 0].cpu().numpy() \
                .astype(np.float64).reshape(B, K)
            tok = nxt.cpu().numpy().reshape(B, K)
            if self._eos is not None:
                tok = np.where(finished, self._eos, tok)
                tok_logp = np.where(finished, 0.0, tok_logp)
            scores += tok_logp
            beams = np.concatenate([beams, tok[:, :, None]], axis=2)
            step_tok = torch.from_numpy(tok.reshape(B * K, 1)).to(dev)
            if penalized:
                seen[rows, step_tok[:, 0]] = True
            if self._eos is not None:
                finished |= tok == self._eos
                if finished.all() and pos < total - 1:
                    pad = np.full((B, K, total - beams.shape[2]), self._eos,
                                  beams.dtype)
                    beams = np.concatenate([beams, pad], axis=2)
                    break
            if pos < total - 1:
                last = model.step(step_tok, caches, pos)[:, -1]
        order = np.argsort(-scores, axis=-1, kind="stable")
        beams = np.take_along_axis(beams, order[:, :, None], axis=1)
        scores = np.take_along_axis(scores, order, axis=-1)
        return torch.from_numpy(beams.astype(np.int32)), scores
