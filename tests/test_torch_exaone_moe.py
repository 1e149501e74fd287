"""K-EXAONE-236B-A23B on the port, at its tiny preset on the CPU, against the
plain reference ``cardbench/reference/exaone_moe.py`` (the benchmark's).

* The configuration: ``registry.get`` finds it, outside ``registry.ARCHS``
  (the JAX package has no twin), and it builds at full width without
  allocating: 23.67 B parameters, this card's EP16 share.
* ``prefill`` equals the reference's full forward in fp32; decode steps past
  the window, through the rings and the global caches, equal the
  reference's full forward at each next position.
* The expert layer: the shares of all ranks, the shared expert counted
  once, add up to the uncut layer; no pair is dropped, however skewed the
  routing.
* The window: K4's wrapper, its plain versions and its tensor-core
  emulation agree; ``window=None`` leaves yi-9b's and internvl2's tiny
  prefills bit-identical to the layer composed as before the window.
* The cell's check on the CPU: a tiny run reads ``correct``; a program
  without the window, one without the shared expert, one with RoPE on the
  global layers and the fp8 control each read not ``correct`` under the
  cell's ``logit_err`` limit.
* On a card only (marker ``card``): the windowed bf16 K4 at d 128, W 128,
  S up to 32768 against the blocked fp32 reference.
"""

import dataclasses
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels.flash_attn import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attn import ref as fref  # noqa: E402
from repro_torch.models import build_model, exact_n_params, init_cache, transformer  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from cardbench import harness  # noqa: E402
from cardbench.reference import exaone_moe  # noqa: E402

ARCH = "k-exaone-236b-a23b"
CELL = "kexaone-long-ttft"
# the configuration file cut to registry.reduced's preset
TINY = dict(test_reduced=True, num_hidden_layers=8, hidden_size=64, num_attention_heads=4,
            num_key_value_heads=1, head_dim=16, intermediate_size=128, moe_intermediate_size=96,
            num_experts=8, experts_held=4, num_experts_per_tok=2, sliding_window=4,
            vocab_size=503, dtype="float32")
OVERRIDES = {"config": TINY, "traffic": {"prompt_len_min": 120, "prompt_len_max": 240,
                                         "n_lengths": 3},
             "cell": {"check_requests": 3}}
# fp32 program against the fp32 reference: the same arithmetic in another
# order (the program's grouped experts and index_add, its GQA layout);
# measured <= 2e-6 of the logits' scale
TOL = 2e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(seed: int = 11, seconds: float = 0.01):
    """(driver, Run, state) of the tiny cell on the CPU, set up."""
    from cardbench.tracing import Trace

    r = harness.Run(CELL, seed, seconds, False, device="cpu", overrides=OVERRIDES)
    r.torch, r.trace = torch, Trace(torch, False, 0.0)
    driver = harness.load_module("drivers", r.traffic["driver"])
    return driver, r, driver.setup(r)


@pytest.fixture(scope="module")
def tiny():
    """The tiny preset's config, the driver, a Run and weights in the reference's layout."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    driver, r, state = _run()
    torch.set_num_threads(n)
    return state.model.cfg, driver, r, state.weights


def _ref_logits(driver, r, weights, tokens, positions):
    return exaone_moe.logits_at(weights, driver.sizes(r.config), [tokens], [positions])[0]


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------

def test_config_is_found_outside_archs_and_builds_at_full_width():
    cfg = registry.get(ARCH)
    assert ARCH not in registry.ARCHS and ARCH in registry.PORT_ONLY
    assert [cfg.windowed(i) for i in range(8)] == [True, True, True, False] * 2
    assert sum(map(cfg.windowed, range(cfg.n_layers))) == 36
    # this card's share: attention, dense layer 0, 47 x (router, 8 experts,
    # the shared expert), embedding and head
    assert exact_n_params(cfg) == 23_668_279_296
    specs = build_model(cfg).param_specs()
    assert specs["we_gate"][0] == (47, 8, 6144, 2048)
    assert specs["router"][0] == (47, 6144, 128) and specs["w_gate"][0] == (1, 6144, 18432)
    caches = transformer.cache_specs(cfg, 1, 32768)
    assert caches["k"][0] == (12, 1, 32768, 8, 128) and caches["k_win"][0] == (36, 1, 128, 8, 128)


def test_driver_refuses_a_program_without_the_architecture(monkeypatch):
    r = harness.Run(CELL, 3, 0.01, False, device="cpu", overrides=OVERRIDES)
    r.torch = torch
    driver = harness.load_module("drivers", r.traffic["driver"])
    monkeypatch.delitem(registry.PORT_ONLY, ARCH)
    t0 = time.perf_counter()
    with pytest.raises(SystemExit, match=ARCH):
        driver.setup(r)
    assert time.perf_counter() - t0 < 5.0


# ---------------------------------------------------------------------------
# prefill and decode against the reference
# ---------------------------------------------------------------------------

def test_prefill_matches_reference(tiny):
    cfg, driver, r, weights = tiny
    tokens = torch.randint(0, cfg.vocab_size, (13,), generator=torch.Generator().manual_seed(5))
    with torch.inference_mode():
        got, cache = transformer.prefill(weights, tokens[None], cfg)
        want = _ref_logits(driver, r, weights, tokens, list(range(13)))
    scale = float(want.abs().max())
    assert float((got[0] - want).abs().max()) <= TOL * scale
    # the rings hold each window layer's last 4 positions at p % 4
    assert cache["k_win"].shape == (6, 1, 4, 1, 16) and cache["k"].shape == (2, 1, 13, 1, 16)


def test_decode_through_rings_matches_reference(tiny):
    cfg, driver, r, weights = tiny
    gen = torch.Generator().manual_seed(6)
    tokens = torch.randint(0, cfg.vocab_size, (2, 6), generator=gen)
    model = build_model(cfg)
    with torch.inference_mode():
        _, pre = model.prefill(weights, tokens)
        cache = init_cache(model, 2, 16, "cpu")
        cache["k"][:, :, :6], cache["v"][:, :, :6] = pre["k"], pre["v"]
        cache["k_win"].copy_(pre["k_win"])
        cache["v_win"].copy_(pre["v_win"])
        kv_len = torch.full((2,), 6, dtype=torch.int32)
        seq = tokens
        for _ in range(7):  # positions 6..12: the rings wrap twice
            nxt = torch.randint(0, cfg.vocab_size, (2,), generator=gen)
            logits, cache = model.decode_step(weights, nxt, cache, kv_len)
            seq = torch.cat([seq, nxt[:, None]], dim=1)
            kv_len = kv_len + 1
            for b in range(2):
                want = _ref_logits(driver, r, weights, seq[b], [seq.shape[1] - 1])[0]
                gap = float((logits[b] - want).abs().max())
                assert gap <= TOL * float(want.abs().max())


def test_serve_run_takes_both_caches():
    from repro_torch.launch import serve

    out = serve.run(serve.ServeConfig(arch=ARCH, n_requests=3, max_batch=2, max_len=16,
                                      prompt_len=6, gen_len=5, device="cpu"))
    assert all(len(t) == 5 for t in out["requests"].values())


# ---------------------------------------------------------------------------
# the expert layer
# ---------------------------------------------------------------------------

def test_expert_shares_of_all_ranks_sum_to_the_uncut_layer(tiny):
    """EP: every rank's share, its shared expert left out, plus the shared
    expert once, is the reference's layer with all experts held.  Rank r
    holds experts [r * held, (r + 1) * held): the program's layer holds the
    first ``held``, so rank r's share is the layer with the router's columns
    rolled to put r's experts first."""
    cfg, driver, r, weights = tiny
    lp = transformer._layer_params({k: weights[k] for k in transformer._LAYER_KEYS
                                    if k in weights}, 3, cfg)
    full = {k: lp[k] for k in ("router", "ws_gate", "ws_up", "ws_down")}
    full.update({k: torch.randn((8,) + lp[k].shape[1:], generator=torch.Generator().manual_seed(
        i)) / lp[k].shape[-2] ** 0.5 for i, k in enumerate(("we_gate", "we_up", "we_down"))})
    h = torch.randn(1, 37, 64, generator=torch.Generator().manual_seed(9))
    held = cfg.experts_held
    share = dataclasses.replace(cfg, n_shared_experts=0)
    total = L.swiglu(h, full["ws_gate"], full["ws_up"], full["ws_down"])
    for rank in range(cfg.n_experts // held):
        part = {k: v[rank * held:(rank + 1) * held] for k, v in full.items() if k[:3] == "we_"}
        part["router"] = torch.roll(full["router"], -rank * held, dims=-1)
        total = total + transformer._moe_dropless(h, part, share)
    ref_cfg = dict(driver.sizes(r.config), experts_held=cfg.n_experts)
    want = exaone_moe._experts(h[0], full, ref_cfg, "fp32")
    assert float((total[0] - want).abs().max()) <= TOL * float(want.abs().max())
    uncut = dataclasses.replace(cfg, experts_held=cfg.n_experts)
    torch.testing.assert_close(transformer._moe_dropless(h, full, uncut)[0], want,
                               rtol=TOL, atol=TOL * float(want.abs().max()))


def test_no_pair_is_dropped(tiny):
    """Every pair that picks a held expert is computed, however skewed the
    routing: a router that sends every token to held experts 0 and 1 (a
    capacity-bounded dispatch would drop most pairs) gives the reference's
    loop over the held experts, and the counters see each routed pair once."""
    cfg, driver, r, weights = tiny
    lp = transformer._layer_params({k: weights[k] for k in transformer._LAYER_KEYS
                                    if k in weights}, 3, cfg)
    router = torch.zeros_like(lp["router"])
    router[:, 0], router[:, 1] = 1.0, 0.5
    lp = dict(lp, router=router)
    S = 41
    h = torch.rand(1, S, cfg.d_model, generator=torch.Generator().manual_seed(5)) + 0.1
    transformer.reset_moe_pairs()
    got = transformer._moe_dropless(h, lp, cfg)[0]
    pairs = dict(transformer.MOE_PAIRS)
    assert pairs == {"held": S * cfg.top_k, "elsewhere": 0}
    want = exaone_moe._experts(h[0], lp, driver.sizes(r.config), "fp32")
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL * float(want.abs().max()))
    # a prefill: each routed pair counted once, held here or elsewhere
    tokens = torch.randint(0, cfg.vocab_size, (3, 10), generator=torch.Generator().manual_seed(2))
    transformer.reset_moe_pairs()
    with torch.inference_mode():
        transformer.prefill(weights, tokens, cfg)
    pairs = dict(transformer.MOE_PAIRS)
    transformer.reset_moe_pairs()
    n_moe = cfg.n_layers - cfg.first_dense_layers
    assert pairs["held"] + pairs["elsewhere"] == 3 * 10 * cfg.top_k * n_moe
    assert pairs["held"] > 0 and pairs["elsewhere"] > 0


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------

def _qkv(S, Hq=4, Hkv=2, d=16, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(1, S, Hq, d, generator=g).to(dtype),
            torch.randn(1, S, Hkv, d, generator=g).to(dtype),
            torch.randn(1, S, Hkv, d, generator=g).to(dtype))


@pytest.mark.parametrize("S, W", [(1, 4), (7, 4), (70, 16), (200, 64), (130, 200)])
def test_window_plain_versions_agree(S, W):
    q, k, v = _qkv(S)
    want = L.plain_attention(q, k, v, window=W)
    torch.testing.assert_close(fops.flash_attention(q, k, v, window=W), want,
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(L.flash_attention(q, k, v, block_k=32, window=W), want,
                               rtol=1e-5, atol=1e-5)
    # the tensor-core kernel's numerics: bf16 P, its key tiles
    emu = fref.flash_attention_tc_emulation(q, k, v, window=W)
    torch.testing.assert_close(emu, want, rtol=3e-2, atol=3e-2)
    # each query's keys, by hand
    i = S - 1
    keys = torch.arange(max(0, i - W + 1), i + 1)
    s = torch.einsum("hd,khd->hk", q[0, i], k[0, keys].repeat_interleave(2, 1)) / 4.0
    o = torch.einsum("hk,khd->hd", s.softmax(-1), v[0, keys].repeat_interleave(2, 1))
    torch.testing.assert_close(want[0, i], o, rtol=1e-5, atol=1e-5)
    if W >= S:
        assert torch.equal(fops.flash_attention(q, k, v, window=W), fops.flash_attention(q, k, v))


@pytest.mark.parametrize("S, W, block, causal", [(70, 16, 16, True), (200, 64, 48, True),
                                                 (130, None, 32, True), (96, None, 40, False)])
def test_plain_k4_in_query_blocks_matches_whole(S, W, block, causal):
    """The plain version in blocks of queries, each over the keys in its
    reach (how the card's smoke run checks K4 at 32768 positions)."""
    q, k, v = _qkv(S)
    torch.testing.assert_close(fref.flash_attention_ref(q, k, v, causal, W, block_q=block),
                               fref.flash_attention_ref(q, k, v, causal, W), rtol=1e-6, atol=1e-6)


def test_window_needs_causal():
    q, k, v = _qkv(8)
    with pytest.raises(ValueError, match="causal"):
        fops.flash_attention(q, k, v, causal=False, window=4)


def _layer_as_before(x, lp, cfg, rope):
    """The dense / VLM layer as it was composed before windows, post-norms
    and the eps field: pre-norms at 1e-6, RoPE on every layer."""
    B, S, _ = x.shape
    h = L.rms_norm(x, lp["ln1"])
    q = L.dense(h, lp["wq"]).reshape(B, S, cfg.n_heads, cfg.hd)
    k = L.dense(h, lp["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    v = L.dense(h, lp["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.hd)
    o = L.plain_attention(L.rotate(q, *rope), L.rotate(k, *rope), v, causal=True)
    x = x + L.dense(o.reshape(B, S, -1), lp["wo"])
    return x + L.swiglu(L.rms_norm(x, lp["ln2"]), lp["w_gate"], lp["w_up"], lp["w_down"])


@pytest.mark.parametrize("arch", ["yi-9b", "internvl2-26b"])
def test_no_window_leaves_prefill_bit_identical(arch):
    cfg = registry.reduced(registry.get(arch))
    assert (cfg.window, cfg.post_norm, cfg.rms_norm_eps, cfg.experts_held) == (0, False, 1e-6, 0)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(4))
    tokens = torch.randint(0, cfg.vocab_size, (2, 9), generator=torch.Generator().manual_seed(3))
    pe = None
    if cfg.family == "vlm":
        pe = torch.rand(2, cfg.frontend_len, cfg.d_model, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        got, cache = model.prefill(params, tokens, pe)
        x = L.embed(params["embed"], tokens)
        if pe is not None:
            x = torch.cat([transformer._patches(pe, params, cfg, x.dtype), x], dim=1)
        rope = L.rope_angles(torch.arange(x.shape[1]), cfg.hd, cfg.rope_theta)
        for i in range(cfg.n_layers):
            lp = {k: v[i] for k, v in params.items() if k in transformer._LAYER_KEYS}
            x = _layer_as_before(x, lp, cfg, rope)
        want = L.dense(L.rms_norm(x, params["final_norm"]), params["lm_head"])
    assert torch.equal(got, want)
    assert set(cache) == {"k", "v"} and cache["k"].shape[0] == cfg.n_layers


# ---------------------------------------------------------------------------
# the cell's check on the CPU
# ---------------------------------------------------------------------------

def _judged(driver, r, state, precision="fp32"):
    driver.window(r, state)
    got = driver.compare(r, state, driver.sample(r, r.records["requests"]), precision)
    nums = driver.numbers(got) if precision == "fp32" else driver.control_numbers(got)
    return harness.judge(r, nums)


def test_tiny_cell_reads_correct():
    driver, r, state = _run(seed=21)
    correct, compared = _judged(driver, r, state)
    assert correct, compared
    assert compared["logit_err"]["value"] < 1e-4
    assert r.records["attempted"] >= 1 and r.records["failed"] == 0
    cfg = state.model.cfg
    per_token = cfg.top_k * (cfg.n_layers - cfg.first_dense_layers)
    assert all(q["held_pairs"] + q["elsewhere_pairs"] == per_token * q["n_text"]
               for q in r.records["requests"])


def _no_window(mp):
    attend = transformer.attend
    mp.setattr(transformer, "attend",
               lambda q, k, v, causal, plain=L.plain_attention, train=False, window=None:
               attend(q, k, v, causal, plain, train))


def _no_shared(mp):
    dropless = transformer._moe_dropless
    mp.setattr(transformer, "_moe_dropless",
               lambda h, lp, cfg: dropless(h, lp, dataclasses.replace(cfg, n_shared_experts=0)))


def _rope_on_global(mp):
    block = transformer._attention_block

    def rotated(x, lp, cfg, rope, *a):
        if rope is None:
            rope = L.rope_angles(torch.arange(x.shape[1]), cfg.hd, cfg.rope_theta)
        return block(x, lp, cfg, rope, *a)

    mp.setattr(transformer, "_attention_block", rotated)


@pytest.mark.parametrize("fault", ["no_window", "no_shared_expert", "rope_on_global", "fp8"])
def test_faults_read_not_correct(monkeypatch, fault):
    {"no_window": _no_window, "no_shared_expert": _no_shared,
     "rope_on_global": _rope_on_global, "fp8": lambda mp: None}[fault](monkeypatch)
    driver, r, state = _run(seed=21)
    correct, compared = _judged(driver, r, state, "fp8" if fault == "fp8" else "fp32")
    assert not correct, compared


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the windowed K4 runs on the card only")
    from repro_torch import resolve_device

    return resolve_device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("S", [128, 1000, 4096, 32768])
def test_windowed_k4_matches_plain_on_the_card(card, S):
    g = torch.Generator(device=card).manual_seed(S)
    q = torch.randn(1, S, 64, 128, generator=g, device=card).bfloat16()
    k = torch.randn(1, S, 8, 128, generator=g, device=card).bfloat16()
    v = torch.randn(1, S, 8, 128, generator=g, device=card).bfloat16()
    n0 = dict(fops.LAUNCHES)
    out = fops.flash_attention(q, k, v, window=128)
    torch.cuda.synchronize()
    assert {n: fops.LAUNCHES[n] - n0[n] for n in n0} == {
        "flash_attention": 1, "flash_attention_tc": 1, "flash_attention_fp32": 0,
        "flash_attention_window": 1, "flash_attention_dv": 0}
    want = exaone_moe._attention(q[0].float(), k[0].float(), v[0].float(), 128, "fp32")
    assert float((out[0].float() - want).abs().max()) <= 3e-2
    # a window past every distance is the causal kernel, bit for bit
    if S <= 4096:
        assert torch.equal(fops.flash_attention(q, k, v, window=S + 64),
                           fops.flash_attention(q, k, v))
