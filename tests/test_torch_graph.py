"""CPU tests of the executor's CUDA-graph policy (``VStep``) and of the
capture-safety repairs around it.

CUDA graphs cannot run here, so ``vstep.GRAPH`` is replaced by a recorder
that behaves as a graph does: its "capture" runs the round once and puts
the state and the token buffer back (a capture executes nothing), its
"replay" runs the round again with no launch counted (a replay runs no
Python) and rewrites the capture's outputs. The kernels' plain versions
run on the CPU and launch nothing; the launch-credit test makes them bump
their wrapper's counter, as a launch on the card would.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch, smoke_config
from repro_torch.kernels import accounting, cdc_decode, cdc_matmul, ref
from repro_torch.models import TPCtx, attention, build
from repro_torch.runtime.executor import SlotPoolExecutor, clone_state, vstep
from repro_torch.serve import ModelStepper

T, R = 4, 2
N_SLOTS = 3
ALL = np.ones(T, bool)


class RecorderGraph:
    """A CPU stand-in for ``vstep.RoundGraph`` with its interface."""
    n_pools = 0

    @staticmethod
    def new_pool():
        RecorderGraph.n_pools += 1
        return object()

    def __init__(self, pool):
        self.pool = pool
        self.launches = {}
        self.outputs = None
        self.n_replays = 0

    def capture(self, fn, *args):
        state, toks = args[0], args[1]
        saved = clone_state(state), toks.clone()
        self.fn, self.args = fn, args
        self.outputs = fn(*args)
        for name, t in saved[0]["kv"].items():
            state["kv"][name].copy_(t)
        toks.copy_(saved[1])

    def replay(self):
        with accounting.uncounted():
            out = self.fn(*self.args)
        for dst, src in zip(self.outputs, out):
            dst.copy_(src)
        self.n_replays += 1


@pytest.fixture
def recorder(monkeypatch):
    monkeypatch.setattr(vstep, "GRAPH", RecorderGraph)
    monkeypatch.setattr(RecorderGraph, "n_pools", 0)
    return RecorderGraph


def _stepper(layout="folded"):
    cfg = smoke_config(get_arch("granite-3-8b"))
    model = build(cfg, TPCtx(tp=T, mode="coded", code_r=R,
                             code_layout=layout))
    params = model.init(0, device="cpu")
    return ModelStepper(model, params, max_len=32), cfg


def _prompts(cfg, n=N_SLOTS):
    rng = np.random.default_rng(5)
    return [rng.integers(0, cfg.vocab, 4 + i) for i in range(n)]


def _serve(pool, cfg, masks, events=None):
    """Admit one prompt per slot, then one round per mask; ``events``
    maps a round index to a callable run before it. Returns the token
    streams."""
    out = [[pool.admit(i, p, masks[0], tag=i)]
           for i, p in enumerate(_prompts(cfg))]
    for i, valid in enumerate(masks):
        if events and i in events:
            events[i]()
        for slot, _, tok in pool.step_round(valid):
            out[slot].append(tok)
    return out


def _dead(*shards):
    v = ALL.copy()
    v[list(shards)] = False
    return v


MASKS = [ALL, ALL, _dead(1), _dead(1), ALL, _dead(2), ALL]


def test_one_capture_per_key_and_a_replay_per_fused_round(recorder):
    stepper, cfg = _stepper()
    pool = SlotPoolExecutor(stepper, N_SLOTS, overlap=False, use_fused=True,
                            use_graphs=True)
    _serve(pool, cfg, MASKS)
    vs = pool.vstep
    assert set(vs._graphs) == {(0, tuple(ALL)), (0, tuple(_dead(1))),
                               (0, tuple(_dead(2)))}
    assert vs.n_captures == 3 and recorder.n_pools == 1
    assert vs.n_replays == vs.n_dispatches == len(MASKS)
    assert sum(g.n_replays for g in vs._graphs.values()) == len(MASKS)
    assert vs.last_variant == "fused"


@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
def test_replayed_tokens_equal_eager_and_reference(recorder, overlap):
    stepper, cfg = _stepper()
    runs = {}
    for name, fused, graphs in (("graph", True, True),
                                ("eager", True, False),
                                ("reference", False, False)):
        pool = SlotPoolExecutor(stepper, N_SLOTS, overlap=overlap,
                                use_fused=fused, use_graphs=graphs)
        runs[name] = _serve(pool, cfg, MASKS + [ALL])
        assert pool.vstep.n_replays == (len(MASKS) + 1 if graphs else 0)
    assert runs["graph"] == runs["eager"] == runs["reference"]


def test_graphs_drop_on_reencode_and_set_code_r(recorder):
    stepper, cfg = _stepper()
    twin, _ = _stepper()
    pools = [SlotPoolExecutor(s, N_SLOTS, overlap=False, use_fused=True,
                              use_graphs=g)
             for s, g in ((stepper, True), (twin, False))]
    streams = []
    for pool in pools:
        st = pool.stepper
        events = {2: st.reencode, 4: lambda st=st: st.set_code_r(1)}
        streams.append(_serve(pool, cfg, [ALL] * 6, events))
    vs = pools[0].vstep
    assert stepper.encode_generation == 2
    assert vs.n_graph_drops == 2 and vs.n_captures == 3
    # a generation's graphs share one pool; a drop retires it
    assert recorder.n_pools == 3
    assert set(vs._graphs) == {(2, tuple(ALL))}
    assert vs.n_replays == 6
    assert streams[0] == streams[1]
    # the head cache follows the encode generation too
    assert vs._generation == 2


def test_two_dead_round_is_eager_reference(recorder):
    """Dedicated r=2 tolerates 2 dead shards: that round takes the eager
    reference variant, neither captured nor replayed."""
    stepper, cfg = _stepper("dedicated")
    pool = SlotPoolExecutor(stepper, N_SLOTS, overlap=False, use_fused=True,
                            use_graphs=True)
    masks = [_dead(1), _dead(1, 3), _dead(1)]
    variants = []
    for i, valid in enumerate(masks):
        if i == 0:
            for s, p in enumerate(_prompts(cfg)):
                pool.admit(s, p, valid, tag=s)
        pool.step_round(valid)
        variants.append(pool.vstep.last_variant)
    assert variants == ["fused", "reference", "fused"]
    assert pool.vstep.n_captures == 1 and pool.vstep.n_replays == 2
    eager = SlotPoolExecutor(stepper, N_SLOTS, overlap=False,
                             use_fused=False)
    ref_toks = _serve(eager, cfg, masks)
    graph = SlotPoolExecutor(stepper, N_SLOTS, overlap=False,
                             use_fused=True, use_graphs=True)
    assert _serve(graph, cfg, masks) == ref_toks


def _counting_plain_versions(monkeypatch):
    """Make the CPU plain versions of kernels 1, 2 and 6 count a launch,
    as their kernels do on the card."""
    for mod, name, wrapper in (
            (cdc_matmul, "coded_matmul_plain", "cdc_coded_matmul"),
            (ref, "fused_head_argmax_ref", "cdc_fused_head_argmax"),
            (ref, "rmsnorm_ref", "rmsnorm")):
        plain = getattr(mod, name)

        def counted(*a, _plain=plain, _w=wrapper, **kw):
            accounting.WRAPPERS[_w].launches += 1
            return _plain(*a, **kw)
        monkeypatch.setattr(mod, name, counted)


def test_replays_credit_the_captured_launches(recorder, monkeypatch):
    """Per replayed round: 5 coded GEMMs a layer, one head and 2L + 1
    norms, exactly; the warm-up before a capture and the capture itself
    count nothing. Every prefill (one per admission) runs 2L + 1 norms."""
    _counting_plain_versions(monkeypatch)
    stepper, cfg = _stepper()
    wrappers = {n: accounting.WRAPPERS[n] for n in
                ("cdc_coded_matmul", "cdc_fused_head_argmax", "rmsnorm")}
    before = {n: w.launches for n, w in wrappers.items()}
    pool = SlotPoolExecutor(stepper, N_SLOTS, overlap=True, use_fused=True,
                            use_graphs=True)
    _serve(pool, cfg, MASKS)
    got = {n: w.launches - before[n] for n, w in wrappers.items()}
    rounds, norms = len(MASKS), 2 * cfg.n_layers + 1
    assert pool.vstep.n_captures == 3
    assert got == {"cdc_coded_matmul": 5 * cfg.n_layers * rounds,
                   "cdc_fused_head_argmax": rounds,
                   "rmsnorm": norms * (rounds + N_SLOTS)}
    delta = next(iter(pool.vstep._graphs.values())).launches
    assert {n: d[0] for n, d in delta.items()} == {
        "cdc_coded_matmul": 5 * cfg.n_layers, "cdc_fused_head_argmax": 1,
        "rmsnorm": norms}


def test_failed_capture_raises(monkeypatch):
    class Broken(RecorderGraph):
        def capture(self, fn, *args):
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
    monkeypatch.setattr(vstep, "GRAPH", Broken)
    stepper, cfg = _stepper()
    pool = SlotPoolExecutor(stepper, N_SLOTS, overlap=False, use_fused=True,
                            use_graphs=True)
    pool.admit(0, _prompts(cfg)[0], ALL, tag=0)
    counts = accounting.snapshot()
    with pytest.raises(RuntimeError, match="capturing"):
        pool.step_round(ALL)
    assert pool.vstep.n_replays == 0 and pool.vstep.n_captures == 0
    assert accounting.snapshot() == counts


def test_graphs_default_off_on_the_cpu():
    stepper, _ = _stepper()
    vs = vstep.VStep(stepper, use_fused=True)
    assert vs.use_fused and not vs.use_graphs
    assert not vstep.VStep(stepper, use_fused=False,
                           use_graphs=True).use_graphs


# ---------------------------------------------- capture-safety repairs ----

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mask_ndim", [2, 3])
def test_mask_fill_with_a_scalar_keeps_the_scores(dtype, mask_ndim):
    """The attention mask now fills with a Python scalar (no host-to-device
    copy inside a round); the scores are the same to the bit as with the
    former device-tensor fill."""
    gen = torch.Generator().manual_seed(0)
    s = torch.randn(2, 3, 4, 5, generator=gen).to(dtype)
    shape = (4, 5) if mask_ndim == 2 else (2, 4, 5)
    msk = torch.rand(shape, generator=gen) > 0.4
    idx = (None, None) if mask_ndim == 2 else (slice(None), None)
    before = torch.where(msk[idx], s, torch.tensor(attention.NEG_INF,
                                                   dtype=s.dtype))
    after = attention._apply_mask(s, msk, 1)
    assert after.dtype == before.dtype
    assert torch.equal(after, before)


def test_head_cache_keys_on_the_encode_generation():
    """The head shards are cached per encode generation (not per id of the
    params dict, which CPython may reuse): a re-encode rebuilds them with
    the same values, and nothing else does."""
    stepper, _ = _stepper()
    vs = vstep.VStep(stepper, use_fused=True)
    w1, p1 = vs._head_shards()
    stepper.params = dict(stepper.params)     # a new dict, same generation
    assert vs._head_shards()[1] is p1
    stepper.reencode()
    w2, p2 = vs._head_shards()
    assert p2 is not p1
    assert torch.equal(w2, w1) and torch.equal(p2, p1)
    assert torch.equal(p2, cdc_decode.head_parity(w2))
