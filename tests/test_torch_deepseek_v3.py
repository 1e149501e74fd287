"""DeepSeek-V3 on the port, at its tiny preset on the CPU, against the plain
reference ``cardbench/reference/deepseek_v3.py`` (the benchmark's).

* The configuration: ``registry.get`` finds it outside ``registry.ARCHS``
  (the JAX package has no twin), and it builds at full width without
  allocating: 19.99 B parameters, the first pipeline stage's EP32 share;
  its latent cache is the only attention state.
* ``Model.prefill`` equals the reference's full forward in fp32 with 4
  groups of 2 experts and the top-2 from the best 2 (the group limit
  binds); prefill, then ``decode_step`` through the latent cache in the
  absorbed form, equals the reference's full forward at every decoded
  position; ``serve.run`` takes the latent cache; the latent counter counts
  (r + p) values a token a layer.
* The expert layer: the shares of all ranks, the shared expert counted
  once, add up to the uncut layer, with groups and the bias.
* Shared paths keep their bits: K-EXAONE's prefill and routing with
  ``n_group`` 1 and no bias, RoPE without ``rope_scaling``, K4's plain
  version and emulation with ``scale=None``.  K4's plain version and
  emulation at dv != d and a given scale agree.
* The cell's check on the CPU: a tiny run reads ``correct``; plain RoPE in
  place of YaRN, the scale without mscale^2, the group limit ignored and
  the fp8 control read not ``correct``; the bias applied to the weights
  moves the reading five orders above a sound run's, under the limit.
* On a card only (marker ``card``): K4's 192/128 instance against the
  plain version at 128 heads, S 4096 and 32768, causal, with MLA's scale;
  the existing instances' outputs keep their digest.
"""

import dataclasses
import hashlib
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels.flash_attn import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attn import ref as fref  # noqa: E402
from repro_torch.models import build_model, exact_n_params, init_cache, mla  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from cardbench import harness  # noqa: E402
from cardbench.reference import deepseek_v3  # noqa: E402

ARCH = "deepseek-v3"
CELL = "dsv3-long-ttft"
# the configuration file cut to registry.reduced's preset
TINY = dict(test_reduced=True, num_hidden_layers=4, hidden_size=64, num_attention_heads=4,
            num_key_value_heads=4, intermediate_size=128, moe_intermediate_size=96,
            n_routed_experts=8, experts_held=4, num_experts_per_tok=2, n_group=4, topk_group=2,
            q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8,
            v_head_dim=16, first_k_dense_replace=1, vocab_size=503, dtype="float32")
OVERRIDES = {"config": TINY, "traffic": {"prompt_len_min": 120, "prompt_len_max": 240,
                                         "n_lengths": 3},
             "cell": {"check_requests": 3}}
# fp32 program against the fp32 reference: the same arithmetic in another
# order (the program's grouped experts, its fused rotations, the absorbed
# decode); measured <= 5e-6 of the logits' scale
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
    return deepseek_v3.logits_at(weights, driver.sizes(r.config), [tokens], [positions])[0]


def _close(got, want):
    assert float((got - want).abs().max()) <= TOL * float(want.abs().max())


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------

def test_config_is_found_outside_archs_and_builds_at_full_width():
    cfg = registry.get(ARCH)
    assert ARCH not in registry.ARCHS and ARCH in registry.PORT_ONLY
    assert (cfg.d_model, cfg.n_heads, cfg.q_lora_rank, cfg.kv_lora_rank) == (7168, 128, 1536, 512)
    assert (cfg.qk_head_dim, cfg.v_head_dim, cfg.rope_dim) == (192, 128, 64)
    assert (cfg.n_experts, cfg.n_group, cfg.topk_group, cfg.top_k) == (256, 8, 4, 8)
    # the first pipeline stage's share: MLA in 31 layers, 3 dense layers, 28 x
    # (router and its bias, 8 experts, the shared expert), embedding and head
    assert exact_n_params(cfg) == 19_992_737_792
    specs = build_model(cfg).param_specs()
    assert specs["wq_b"][0] == (31, 1536, 128 * 192) and specs["wkv_a"][0] == (31, 7168, 576)
    assert specs["wkv_b"][0] == (31, 512, 128 * 256) and specs["wo"][0] == (31, 128 * 128, 7168)
    assert specs["router_bias"][0] == (28, 256) and specs["router_bias"][2] == "float32"
    assert specs["we_gate"][0] == (28, 8, 7168, 2048) and specs["w_gate"][0] == (3, 7168, 18432)
    assert not {"wq", "wk", "wv"} & set(specs)
    # the latent cache alone: 576 values a token a layer, 1.17 GB at 32768
    caches = transformer.cache_specs(cfg, 1, 32768)
    assert set(caches) == {"c_kv", "k_pe"}
    assert caches["c_kv"][0] == (31, 1, 32768, 1, 512)
    assert caches["k_pe"][0] == (31, 1, 32768, 1, 64)
    nbytes = sum(2 * torch.Size(s).numel() for s, _, _ in caches.values())
    assert nbytes == 576 * 2 * 32768 * 31 == 1_170_210_816
    # the softmax scale: 192^-1/2 (0.1 ln 40 + 1)^2
    assert mla.softmax_scale(cfg) == pytest.approx(192 ** -0.5 * 1.8739, rel=1e-4)


def test_driver_refuses_a_program_without_the_architecture(monkeypatch):
    r = harness.Run(CELL, 3, 0.01, False, device="cpu", overrides=OVERRIDES)
    r.torch = torch
    driver = harness.load_module("drivers", r.traffic["driver"])
    monkeypatch.delitem(registry.PORT_ONLY, ARCH)
    t0 = time.perf_counter()
    with pytest.raises(SystemExit, match=ARCH):
        driver.setup(r)
    assert time.perf_counter() - t0 < 5.0


def test_reference_and_counts_load_no_program():
    """The plain reference imports no kernel of the port and no JAX."""
    import subprocess

    code = ("import sys; sys.path.insert(0, %r)\n"
            "import cardbench.reference.deepseek_v3, cardbench.counts.deepseek\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    tops = set(eval(proc.stdout.strip().splitlines()[-1]))
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_yarn_angles_match_the_reference():
    cfg = registry.get(ARCH)
    sizes = {"qk_rope_head_dim": 64, "rope_theta": 10000, "rope_scaling": {
        "factor": 40, "original_max_position_embeddings": 4096, "beta_fast": 32, "beta_slow": 1,
        "mscale": 1, "mscale_all_dim": 1}}
    cos, sin = L.rope_angles(torch.arange(5000), 64, cfg.rope_theta, cfg.rope_scaling)
    rcos, rsin = deepseek_v3.rope_tables(sizes, 5000, "cpu")
    torch.testing.assert_close(cos[:, 0], rcos[:, :32], rtol=0, atol=1e-6)
    torch.testing.assert_close(sin[:, 0], rsin[:, 32:], rtol=0, atol=1e-6)
    # the correction range 10..23 of 32 frequencies: extrapolated up to 10,
    # divided by 40 from 23, a linear ramp between
    plain = L.rope_frequencies(64, 1e4)
    yarn = L.rope_frequencies(64, 1e4, scaling=cfg.rope_scaling)
    assert torch.equal(yarn[:11], plain[:11])
    torch.testing.assert_close(yarn[23:], plain[23:] / 40, rtol=1e-6, atol=0)
    assert bool(((yarn[11:23] < plain[11:23]) & (yarn[11:23] > plain[11:23] / 40)).all())


@pytest.mark.parametrize("hd, theta", [(128, 1e4), (128, 1e6), (64, 1e4), (16, 1e4), (80, 5e5)])
def test_rope_without_scaling_is_bit_equal(hd, theta):
    """No ``rope_scaling``: the frequencies and angles of before, bit for bit."""
    exps = torch.arange(0, hd, 2, dtype=torch.float32) / hd
    assert torch.equal(L.rope_frequencies(hd, theta), 1.0 / (theta ** exps))
    pos = torch.arange(300)
    ang = pos[:, None].to(torch.float32) * (1.0 / (theta ** exps))
    cos, sin = L.rope_angles(pos, hd, theta)
    assert torch.equal(cos, torch.cos(ang)[:, None, :])
    assert torch.equal(sin, torch.sin(ang)[:, None, :])


# ---------------------------------------------------------------------------
# prefill and decode against the reference
# ---------------------------------------------------------------------------

def test_prefill_matches_reference_with_binding_groups(tiny):
    cfg, driver, r, weights = tiny
    tokens = torch.randint(0, cfg.vocab_size, (37,), generator=torch.Generator().manual_seed(5))
    model = build_model(cfg)
    with torch.inference_mode():
        got, cache = model.prefill(weights, tokens[None])
        want = _ref_logits(driver, r, weights, tokens, list(range(37)))
    _close(got[0], want)
    assert set(cache) == {"c_kv", "k_pe"} and cache["c_kv"].shape == (4, 1, 37, 1, 16)
    # the group limit binds: without it some tokens pick other experts
    lp = transformer._layer_params({k: weights[k] for k in transformer._LAYER_KEYS
                                    if k in weights}, 2, cfg)
    h = torch.randn(200, cfg.d_model, generator=torch.Generator().manual_seed(1))
    s = torch.sigmoid(h @ lp["router"])
    grouped = transformer._limited_topk(s, lp["router_bias"], cfg)[1].sort(-1)[0]
    free = transformer._limited_topk(s, lp["router_bias"],
                                     dataclasses.replace(cfg, n_group=1))[1].sort(-1)[0]
    assert bool((grouped != free).any(-1).any())


def test_decode_through_latent_cache_matches_reference(tiny):
    cfg, driver, r, weights = tiny
    gen = torch.Generator().manual_seed(6)
    tokens = torch.randint(0, cfg.vocab_size, (2, 6), generator=gen)
    model = build_model(cfg)
    with torch.inference_mode():
        _, pre = model.prefill(weights, tokens)
        cache = init_cache(model, 2, 16, "cpu")
        assert set(cache) == {"c_kv", "k_pe"}
        cache["c_kv"][:, :, :6], cache["k_pe"][:, :, :6] = pre["c_kv"], pre["k_pe"]
        kv_len = torch.full((2,), 6, dtype=torch.int32)
        seq = tokens
        for _ in range(7):
            nxt = torch.randint(0, cfg.vocab_size, (2,), generator=gen)
            logits, cache = model.decode_step(weights, nxt, cache, kv_len)
            seq = torch.cat([seq, nxt[:, None]], dim=1)
            kv_len = kv_len + 1
            for b in range(2):
                _close(logits[b], _ref_logits(driver, r, weights, seq[b], [seq.shape[1] - 1])[0])


def test_serve_run_takes_the_latent_cache():
    from repro_torch.launch import serve

    out = serve.run(serve.ServeConfig(arch=ARCH, n_requests=3, max_batch=2, max_len=16,
                                      prompt_len=6, gen_len=5, device="cpu"))
    assert all(len(t) == 5 for t in out["requests"].values())


def test_latent_counter_counts_the_cache_a_prefill_writes(tiny):
    cfg, _, _, weights = tiny
    tokens = torch.randint(0, cfg.vocab_size, (3, 11), generator=torch.Generator().manual_seed(8))
    mla.reset_latent_bytes()
    with torch.inference_mode():
        _, cache = transformer.prefill(weights, tokens, cfg)
    # (r + p) values a token a layer, fp32 here: 576 x 2 bytes at full width in bf16
    per_value = 4
    assert mla.LATENT_BYTES["prefill"] == (16 + 8) * per_value * 3 * 11 * cfg.n_layers
    assert mla.LATENT_BYTES["prefill"] == sum(t.nbytes for t in cache.values())
    mla.reset_latent_bytes()
    assert mla.LATENT_BYTES["prefill"] == 0


# ---------------------------------------------------------------------------
# the expert layer
# ---------------------------------------------------------------------------

def test_expert_shares_of_all_ranks_sum_to_the_uncut_layer(tiny):
    """EP with groups and the bias: every rank's share, its shared expert
    left out, plus the shared expert once, is the reference's layer with all
    experts held.  Rank r holds experts [r * held, (r + 1) * held): its share
    is the program's layer with the router's columns and the bias rolled to
    put r's experts first, which keeps the groups whole (held is a multiple
    of a group's 2)."""
    cfg, driver, r, weights = tiny
    lp = transformer._layer_params({k: weights[k] for k in transformer._LAYER_KEYS
                                    if k in weights}, 2, cfg)
    full = {k: lp[k] for k in ("router", "router_bias", "ws_gate", "ws_up", "ws_down")}
    full.update({k: torch.randn((8,) + lp[k].shape[1:], generator=torch.Generator().manual_seed(
        i)) / lp[k].shape[-2] ** 0.5 for i, k in enumerate(("we_gate", "we_up", "we_down"))})
    h = torch.randn(1, 37, 64, generator=torch.Generator().manual_seed(9))
    held = cfg.experts_held
    share = dataclasses.replace(cfg, n_shared_experts=0)
    total = L.swiglu(h, full["ws_gate"], full["ws_up"], full["ws_down"])
    for rank in range(cfg.n_experts // held):
        part = {k: v[rank * held:(rank + 1) * held] for k, v in full.items() if k[:3] == "we_"}
        part["router"] = torch.roll(full["router"], -rank * held, dims=-1)
        part["router_bias"] = torch.roll(full["router_bias"], -rank * held, dims=-1)
        total = total + transformer._moe_dropless(h, part, share)
    ref_cfg = dict(driver.sizes(r.config), experts_held=cfg.n_experts)
    want = deepseek_v3._experts(h[0], full, ref_cfg, "fp32")
    _close(total[0], want)
    uncut = dataclasses.replace(cfg, experts_held=cfg.n_experts)
    _close(transformer._moe_dropless(h, full, uncut)[0], want)


def _dropless_before(h, lp, cfg):
    """The dropless layer's routing as it was before groups and the bias."""
    x = h.reshape(-1, h.shape[-1])
    logits = torch.matmul(x.to(torch.float32), lp["router"].to(torch.float32))
    return torch.topk(torch.sigmoid(logits), cfg.top_k, dim=-1)


def test_kexaone_routing_and_prefill_keep_their_bits(monkeypatch):
    """``n_group`` 1 and no bias: the selection is one top-k a layer, and a
    prefill and the routing are bit-identical to the routing of before."""
    cfg = registry.reduced(registry.get("k-exaone-236b-a23b"))
    assert (cfg.n_group, cfg.topk_group, cfg.kv_lora_rank, cfg.rope_scaling) == (1, 1, 0, None)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(4))
    assert "router_bias" not in params
    tokens = torch.randint(0, cfg.vocab_size, (2, 9), generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        got, _ = model.prefill(params, tokens)

    calls = []
    topk = torch.topk

    def counted(*a, **k):
        calls.append(1)
        return topk(*a, **k)

    monkeypatch.setattr(torch, "topk", counted)
    with torch.inference_mode():
        model.prefill(params, tokens)
    assert len(calls) == cfg.n_layers - cfg.first_dense_layers
    monkeypatch.setattr(torch, "topk", topk)
    monkeypatch.setattr(transformer, "_limited_topk",
                        lambda scores, bias, cfg: torch.topk(scores, cfg.top_k, dim=-1))
    with torch.inference_mode():
        before, _ = model.prefill(params, tokens)
    assert torch.equal(got, before)
    lp = transformer._layer_params({k: params[k] for k in transformer._LAYER_KEYS
                                    if k in params}, 3, cfg)
    h = torch.randn(1, 13, cfg.d_model, generator=torch.Generator().manual_seed(2))
    before = _dropless_before(h, lp, cfg)
    x = h.reshape(-1, cfg.d_model)
    s = torch.sigmoid(torch.matmul(x, lp["router"]))
    monkeypatch.undo()
    v, i = transformer._limited_topk(s, None, cfg)
    assert torch.equal(i, before[1]) and torch.equal(v, before[0])


# ---------------------------------------------------------------------------
# K4 at dv != d and with a scale
# ---------------------------------------------------------------------------

def _qkv(S, Hq=4, Hkv=4, d=24, dv=16, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(1, S, Hq, d, generator=g).to(dtype),
            torch.randn(1, S, Hkv, d, generator=g).to(dtype),
            torch.randn(1, S, Hkv, dv, generator=g).to(dtype))


@pytest.mark.parametrize("S, causal, scale", [(1, True, None), (70, True, 0.37), (130, True, 0.2),
                                              (96, False, 0.45), (200, True, None)])
def test_k4_plain_versions_agree_at_a_narrower_v_and_a_scale(S, causal, scale):
    q, k, v = _qkv(S)
    want = L.plain_attention(q, k, v, causal=causal, scale=scale)
    assert want.shape == (1, S, 4, 16)
    torch.testing.assert_close(fops.flash_attention(q, k, v, causal, scale=scale), want,
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(L.flash_attention(q, k, v, causal=causal, block_k=32, scale=scale),
                               want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(fref.flash_attention_ref(q, k, v, causal, block_q=48, scale=scale),
                               want, rtol=1e-5, atol=1e-5)
    # the tensor-core kernel's numerics: bf16 P, its key tiles (128 at dv 16)
    emu = fref.flash_attention_tc_emulation(q, k, v, causal, scale=scale)
    torch.testing.assert_close(emu, want, rtol=3e-2, atol=3e-2)
    torch.testing.assert_close(fref.flash_attention_tc_emulation(q, k, v, causal, block_k=32,
                                                                 scale=scale), emu,
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("d", [16, 64, 128])
def test_k4_scale_none_is_the_scale_of_before(d):
    q, k, v = _qkv(90, d=d, dv=d, seed=d)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / (d ** 0.5)
    keep = torch.arange(90)[:, None] >= torch.arange(90)[None]
    p = torch.softmax(s.masked_fill(~keep, -1e30), dim=-1)
    before = torch.einsum("bhqk,bkhd->bqhd", p, v)
    torch.testing.assert_close(fref.flash_attention_ref(q, k, v), before, rtol=1e-6, atol=1e-6)
    assert torch.equal(fref.flash_attention_ref(q, k, v),
                       fref.flash_attention_ref(q, k, v, scale=None))
    assert torch.equal(fref.flash_attention_tc_emulation(q, k, v),
                       fref.flash_attention_tc_emulation(q, k, v, scale=1.0 / d ** 0.5))
    assert torch.equal(L.plain_attention(q, k, v), L.plain_attention(q, k, v, scale=None))
    assert fref.tc_key_tile(d) == fref.tc_key_tile(d, d)


def test_k4_variants_of_a_narrower_v():
    assert fops.variant(torch.bfloat16, 192, 128) == "tc"
    assert fref.tc_key_tile(192, 128) == 128 and fref.tc_key_tile(256) == 64
    with pytest.raises(ValueError, match="bf16"):
        fops.variant(torch.float32, 192, 128)
    with pytest.raises(ValueError, match="192"):
        fops.variant(torch.bfloat16, 128, 64)
    q, k, v = _qkv(8)
    with pytest.raises(ValueError, match="window"):
        fops.flash_attention(q, k, v, window=4)
    with pytest.raises(ValueError, match="do not fit"):
        fops.flash_attention(q, k, v[:, :7])


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
    n_tokens = sum(q["n_text"] for q in r.records["requests"])
    assert r.records["latent_bytes"] == n_tokens * (16 + 8) * 4 * cfg.n_layers


def _plain_rope(mp):
    angles = L.rope_angles
    mp.setattr(L, "rope_angles", lambda p, hd, theta, scaling=None: angles(p, hd, theta))


def _no_mscale(mp):
    mp.setattr(mla, "softmax_scale", lambda cfg: cfg.qk_head_dim ** -0.5)


def _no_groups(mp):
    limited = transformer._limited_topk
    mp.setattr(transformer, "_limited_topk",
               lambda s, bias, cfg: limited(s, bias, dataclasses.replace(cfg, n_group=1)))


def _bias_on_weights(mp):
    limited = transformer._limited_topk

    def biased(s, bias, cfg):
        idx = limited(s, bias, cfg)[1]
        return (s + bias).gather(1, idx), idx

    mp.setattr(transformer, "_limited_topk", biased)


FAULTS = {"plain_rope": _plain_rope, "no_mscale": _no_mscale, "no_groups": _no_groups,
          "fp8": lambda mp: None}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_faults_read_not_correct(monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    driver, r, state = _run(seed=21)
    correct, compared = _judged(driver, r, state, "fp8" if fault == "fp8" else "fp32")
    assert not correct, compared


def test_bias_on_the_weights_moves_the_check(monkeypatch):
    """The selection-only bias put on the weights too: the check's reading
    rises from the fp32 floor (~1e-6) by five orders, but stays under the
    cell's limit (0.15 here): the chosen experts' scores lie near 0.9, so
    adding a bias of 0.05 moves each normalised weight by a few percent
    (PERF.md section 7)."""
    driver, r, state = _run(seed=21)
    sound = _judged(driver, r, state)[1]["logit_err"]["value"]
    _bias_on_weights(monkeypatch)
    driver, r, state = _run(seed=21)
    assert _judged(driver, r, state)[1]["logit_err"]["value"] > 1e4 * sound


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: K4's 192/128 instance runs on the card only")
    from repro_torch import resolve_device

    return resolve_device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("S", [1000, 4096, 32768])
def test_k4_192_128_matches_plain_on_the_card(card, S):
    scale = mla.softmax_scale(registry.get(ARCH))
    g = torch.Generator(device=card).manual_seed(S)
    q = torch.randn(1, S, 128, 192, generator=g, device=card).bfloat16()
    k = torch.randn(1, S, 128, 192, generator=g, device=card).bfloat16()
    v = torch.randn(1, S, 128, 128, generator=g, device=card).bfloat16()
    fops.reset_launch_counts()
    with torch.inference_mode():
        out = fops.flash_attention(q, k, v, True, scale=scale)
        again = fops.flash_attention(q, k, v, True, scale=scale)
    torch.cuda.synchronize()
    assert dict(fops.LAUNCHES) == {"flash_attention": 2, "flash_attention_tc": 2,
                                   "flash_attention_fp32": 0, "flash_attention_window": 0,
                                   "flash_attention_dv": 2}
    assert out.shape == (1, S, 128, 128) and torch.equal(out, again)
    with torch.inference_mode():
        want = fref.flash_attention_ref(q, k, v, True, block_q=256, scale=scale)
    gap, want = out.float() - want.float(), want.float()
    assert float(gap.abs().max()) <= 3e-2
    # outputs lie near 0.04 at 32768, so the gap's RMS is held to 1% of the
    # output's besides (chip_smoke.MLA_REL_TOL)
    assert float(gap.square().mean().sqrt()) <= 1e-2 * float(want.square().mean().sqrt())


@pytest.mark.card
def test_k4_digest_of_the_existing_instances():
    """The card's outputs of the instances of before, at the shapes
    ``cardbench/tools/exaone_checks.py k4-bits`` digests, keep its digest."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: K4 runs on the card only")
    digest = hashlib.sha256()
    for S, Hq, Hkv in ((4096, 32, 4), (4352, 48, 8), (4096, 64, 8), (1000, 64, 8)):
        g = torch.Generator(device="cuda").manual_seed(S + Hq)
        q = torch.randn(1, S, Hq, 128, generator=g, device="cuda").bfloat16()
        k = torch.randn(1, S, Hkv, 128, generator=g, device="cuda").bfloat16()
        v = torch.randn(1, S, Hkv, 128, generator=g, device="cuda").bfloat16()
        digest.update(fops.flash_attention(q, k, v, True).view(torch.int16).cpu().numpy().tobytes())
    assert digest.hexdigest().startswith("5a584f73")
