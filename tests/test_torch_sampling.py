"""Temperature sampling in the port: `serve.sample`, `generate(temperature=,
key=)`, the Scheduler's per-request generators and the launcher's
`--temperature`, on qwen2-1.5b SMOKE in f32 on the CPU.

torch has no JAX PRNG, so sampled tokens cannot equal the JAX package's.
Sampled runs are held instead to: the refusals of a positive temperature
without a key (in both entry points, as the JAX package refuses them); a
first token that is itself sampled from the prefill logits; the same
tokens from the same seed; draws that follow softmax(row / T) (20 000
draws from one fixed row at T = 0.7, each token's count within 5
binomial sigma of its probability); and temperature 0 equal to greedy,
the JAX package's greedy tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as JT
from repro.serve_lib import serve as jax_serve
from repro.serve_lib.scheduler import Request as JaxRequest
from repro.serve_lib.scheduler import Scheduler as JaxScheduler
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.serve_lib import serve
from repro_torch.serve_lib.scheduler import Request, Scheduler

ARCH = "qwen2-1.5b"


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_get_config(ARCH, smoke=True)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, get_config(ARCH, smoke=True), params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu")


def _scfg(**kw):
    return serve.ServeConfig(max_seq=32, batch=2, compute_dtype="float32",
                             cache_dtype="float32", device="cpu",
                             kernel_backend="hopper", **kw)


def _prompt(cfg, seed=1, batch=2, length=6):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab, (batch, length)).astype(np.int32))


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_generate_without_a_key_is_refused(weights):
    jcfg, jparams, cfg, params = weights
    want = _message(lambda: jax_serve.generate(
        jparams, jcfg, jax_serve.ServeConfig(max_seq=32, batch=2,
                                             compute_dtype=jnp.float32),
        jnp.zeros((2, 6), jnp.int32), 2, temperature=0.7))
    got = _message(lambda: serve.generate(params, cfg, _scfg(), _prompt(cfg),
                                          2, temperature=0.7))
    assert "key" in got and "key" in want
    assert got.split("—")[0] == want.split("—")[0]


def test_submit_without_a_key_is_refused(weights):
    jcfg, jparams, cfg, params = weights
    req = dict(uid=0, prompt=np.ones(4, np.int32), max_new_tokens=2,
               temperature=0.5)
    want = _message(lambda: JaxScheduler(jparams, jcfg, jax_serve.ServeConfig(
        max_seq=32, batch=2, compute_dtype=jnp.float32)).submit(
            JaxRequest(**req)))
    got = _message(lambda: Scheduler(params, cfg, _scfg()).submit(
        Request(**req)))
    assert got.startswith(want)


def test_generate_samples_its_first_token(weights):
    """At T = 4 the first token, drawn from the prefill logits, is not
    always the argmax: 12 seeds give more than one first token."""
    _, _, cfg, params = weights
    prompt = _prompt(cfg, batch=2)
    firsts = {int(serve.generate(
        params, cfg, _scfg(), prompt, 1, temperature=4.0,
        key=torch.Generator().manual_seed(seed))[0, 0])
        for seed in range(12)}
    assert len(firsts) > 1


def test_scheduler_samples_its_first_token(weights):
    _, _, cfg, params = weights
    prompt = _prompt(cfg, batch=1)[0].numpy()
    firsts = set()
    for seed in range(12):
        sched = Scheduler(params, cfg, _scfg())
        done = sched.run([Request(uid=0, prompt=prompt, max_new_tokens=1,
                                  temperature=4.0,
                                  key=torch.Generator().manual_seed(seed))])
        firsts.add(int(done[0].tokens[0]))
    assert len(firsts) > 1


def test_generate_same_seed_same_tokens(weights):
    _, _, cfg, params = weights
    prompt = _prompt(cfg)
    run = lambda seed: serve.generate(  # noqa: E731
        params, cfg, _scfg(), prompt, 8, temperature=1.0,
        key=torch.Generator().manual_seed(seed))
    a, b, c = run(3), run(3), run(4)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_scheduler_same_seed_same_tokens(weights):
    """Per-request generators: the same seeds give the same tokens, a
    request's own generator is left as it was (the slot draws from a
    copy), and a greedy request beside sampled ones decodes greedily."""
    _, _, cfg, params = weights
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, 4 + i).astype(np.int32)
               for i in range(4)]
    keys = [torch.Generator().manual_seed(10 + i) for i in range(3)]
    state = keys[0].get_state()

    def run():
        reqs = [Request(uid=i, prompt=prompts[i], max_new_tokens=6,
                        temperature=1.0, key=keys[i]) for i in range(3)]
        reqs.append(Request(uid=3, prompt=prompts[3], max_new_tokens=6))
        done = Scheduler(params, cfg, _scfg()).run(reqs)
        return {u: c.tokens.tolist() for u, c in done.items()}

    first, second = run(), run()
    assert first == second
    assert torch.equal(keys[0].get_state(), state)
    greedy = Scheduler(params, cfg, _scfg()).run(
        [Request(uid=3, prompt=prompts[3], max_new_tokens=6)])
    assert first[3] == greedy[3].tokens.tolist()


def test_draws_follow_softmax_over_temperature():
    """20 000 draws from one fixed row at T = 0.7: each token's count
    within 5 binomial sigma of n softmax(row / T)."""
    row = torch.from_numpy(np.random.default_rng(0).standard_normal(
        50).astype(np.float32))
    n, temperature = 20_000, 0.7
    draws = serve.sample(row.expand(n, -1), temperature,
                         torch.Generator().manual_seed(0))
    counts = np.bincount(draws.numpy(), minlength=50)
    p = torch.softmax(row.double() / temperature, dim=-1).numpy()
    sigma = np.sqrt(n * p * (1 - p))
    assert np.all(np.abs(counts - n * p) <= 5 * sigma + 1e-9), (
        np.abs(counts - n * p) / np.maximum(sigma, 1e-12)).max()


def test_temperature_zero_is_greedy(weights):
    """temperature = 0: `generate` and the Scheduler give the greedy
    tokens, which are the JAX package's."""
    jcfg, jparams, cfg, params = weights
    prompt = _prompt(cfg)
    want = jax_serve.generate(jparams, jcfg, jax_serve.ServeConfig(
        max_seq=32, batch=2, compute_dtype=jnp.float32,
        cache_dtype=jnp.float32), jnp.asarray(prompt.numpy()), 6)
    got = serve.generate(params, cfg, _scfg(), prompt, 6, temperature=0.0,
                         key=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    done = Scheduler(params, cfg, _scfg()).run(
        [Request(uid=i, prompt=prompt[i].numpy(), max_new_tokens=6,
                 temperature=0.0) for i in range(2)])
    for i in range(2):
        np.testing.assert_array_equal(done[i].tokens, np.asarray(want)[i])


def test_launcher_temperature_in_both_modes():
    """`--temperature` through the launcher: static mode and trace mode
    (a generator a request, seeded from --seed) repeat their tokens for
    the same seed."""
    static = ["--arch", ARCH, "--smoke", "--device", "cpu",
              "--kernel-backend", "hopper", "--temperature", "0.9",
              "--batch", "2", "--prompt-len", "6", "--gen", "4"]
    a, b = launch_serve.main(static), launch_serve.main(static)
    assert torch.equal(a["tokens"], b["tokens"])
    trace = ["--arch", ARCH, "--smoke", "--device", "cpu",
             "--kernel-backend", "hopper", "--temperature", "0.9",
             "--batch", "2", "--trace", "12x4,6x3*2"]
    runs = [launch_serve.main(trace)["scheduler"].completions
            for _ in range(2)]
    assert {u: c.tokens.tolist() for u, c in runs[0].items()} == {
        u: c.tokens.tolist() for u, c in runs[1].items()}
    with pytest.raises(SystemExit, match="greedy"):
        launch_serve.main(trace + ["--speculate", "2"])
