"""The port's on-device sampling (``serve.engine.sample`` and
``ServeEngine.generate(temperature=, top_k=, seed=)``) at smoke size on the
CPU: the greedy limits, determinism under a seed, the top-k support, and
the draw frequencies against the softmax.

The reference samples with ``jax.random.categorical`` from a JAX PRNG key,
the port from a ``torch.Generator`` seeded with the same integer. The two
generators give different random bits, so their sampled tokens are not
comparable token for token; these tests hold the port to the distribution
the reference defines instead (the greedy tokens, where the distribution
is a point, come from the reference's own engine in
tests/test_torch_serve.py and tests/test_torch_cache_serve.py)."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.serve.engine import sample  # noqa: E402

ARCH = "llama-1b-armt"
# Pearson chi-square bounds at p = 1e-4 (scipy.stats.chi2.isf(1e-4, df)):
# df 7 -> 29.88, df 3 -> 21.11. The draws come from a fixed seed, so a
# passing test passes every time; the bound says how unlikely a correct
# sampler is to exceed it for a seed picked at random.
CHI2_P1E4 = {7: 29.88, 3: 21.11}


@pytest.fixture(scope="module", params=["armt", "cache"])
def engine(request):
    cfg = get_smoke_config(ARCH)
    params = tmodel.init_params(cfg, 0, device="cpu")
    return ServeEngine(params, cfg, serve_mode=request.param, max_len=128, device="cpu")


def _prompts(engine, seed, B=2, P=21):
    return np.random.default_rng(seed).integers(0, engine.cfg.vocab, (B, P))


def test_greedy_limits(engine):
    """top_k = 1 is the greedy choice, and a tiny temperature scales the
    logits' gaps past any Gumbel noise: both give the greedy tokens."""
    prompts = _prompts(engine, 1)
    greedy = engine.generate(prompts, 24).tokens
    assert np.array_equal(engine.generate(prompts, 24, temperature=0.8, top_k=1,
                                          seed=5).tokens, greedy)
    assert np.array_equal(engine.generate(prompts, 24, temperature=1e-6, seed=6).tokens,
                          greedy)


def test_same_seed_same_tokens_other_seeds_differ(engine):
    prompts = _prompts(engine, 2)
    kw = dict(temperature=1.0, top_k=0)
    a = engine.generate(prompts, 24, seed=0, **kw).tokens
    assert np.array_equal(engine.generate(prompts, 24, seed=0, **kw).tokens, a)
    others = [engine.generate(prompts, 24, seed=s, **kw).tokens for s in (1, 2, 3)]
    assert all(not np.array_equal(o, a) for o in others)
    assert not np.array_equal(a, engine.generate(prompts, 24).tokens)


def test_generated_tokens_lie_in_the_top_k(engine):
    """With top_k = 3 each token is one of the 3 largest logits of its
    step: the step's logits recomputed by feeding the sampled tokens back
    through prefill."""
    prompts = _prompts(engine, 3, B=1)
    toks = engine.generate(prompts, 12, temperature=2.0, top_k=3, seed=4).tokens
    for i in range(toks.shape[1]):
        seq = np.concatenate([prompts, toks[:, :i]], axis=1)
        logits = engine.prefill(torch.from_numpy(seq))[0]
        top = torch.topk(logits, 3, dim=-1).indices[0].tolist()
        assert int(toks[0, i]) in top, (i, int(toks[0, i]), top)


def test_sample_support_is_the_top_k():
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn(500, 50, generator=gen)
    draws = sample(logits, temperature=3.0, top_k=5, generator=gen)
    kth = torch.topk(logits, 5, dim=-1).values[:, -1]
    assert draws.shape == (500,) and draws.dtype == torch.long
    assert (logits.gather(1, draws[:, None])[:, 0] >= kth).all()
    assert len(set(draws.tolist())) > 5        # the support is per row


@pytest.mark.parametrize("temperature,top_k", [(1.0, 0), (0.7, 0), (1.3, 4)])
def test_sample_frequencies_match_softmax(temperature, top_k):
    """40,000 draws from one fixed 8-way logits vector: the counts against
    softmax(logits / temperature) (renormalised over the top k when k > 0,
    zero outside it) within the chi-square bound at p = 1e-4."""
    logits = torch.tensor([1.5, 0.2, -0.7, 2.1, 0.9, -2.0, 0.0, 1.1])
    n = 40_000
    gen = torch.Generator().manual_seed(1234)
    draws = sample(logits.expand(n, -1), temperature=temperature, top_k=top_k,
                   generator=gen)
    counts = np.bincount(draws.numpy(), minlength=8).astype(np.float64)
    p = torch.softmax(logits.double() / temperature, -1).numpy()
    if top_k:
        keep = np.argsort(-logits.numpy())[:top_k]
        mask = np.zeros(8, bool)
        mask[keep] = True
        assert counts[~mask].sum() == 0
        p, counts = p[mask] / p[mask].sum(), counts[mask]
    chi2 = float(((counts - n * p) ** 2 / (n * p)).sum())
    assert chi2 < CHI2_P1E4[len(p) - 1], (chi2, counts, n * p)


def test_greedy_needs_no_generator():
    logits = torch.randn(3, 9)
    assert torch.equal(sample(logits, temperature=0.0, top_k=7, generator=None),
                       logits.argmax(-1))


def test_ties_at_the_top():
    """Logits tied at the largest value (bf16 logits over a large vocabulary
    tie): top_k = 1 takes the first of them, as greedy does; a larger top_k
    keeps every tied logit (the reference's value mask) and draws among
    them."""
    logits = torch.tensor([[0.5, 2.0, -1.0, 2.0, 2.0, 1.0]]).expand(3000, -1)
    gen = torch.Generator().manual_seed(9)
    top1 = sample(logits, temperature=1.0, top_k=1, generator=gen)
    assert (top1 == 1).all()
    top2 = sample(logits, temperature=1.0, top_k=2, generator=gen)
    assert set(top2.tolist()) == {1, 3, 4}
