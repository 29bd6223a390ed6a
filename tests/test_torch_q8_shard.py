"""The q8 AdamW update on a rank's own rows (``repro_torch.optim.q8_shard``)
against the whole-leaf update (``moment_step`` + ``apply_step``), on
spawned gloo ranks (``tests/_torch_dist.py``).

* The update alone, at meshes (2, 2), (4, 1) and (1, 4) on four ranks
  and (pod 2, data 2, model 2) on eight, twice in a row (the first from
  nonzero q8 moments): every rank's parameter shard, ``q`` and ``scale``
  rows and their fp32 moments equal the same shards of the whole-leaf
  update's bit for bit. The leaves cover 256-blocks that straddle
  ``model`` shards (a narrow width, split on the last dim and on the
  first), rows that do not divide over ``data`` (replicated), FSDP leaves
  (over ``data``, with and without a ``model`` split, rows divided and
  replicated), and leaves split over neither axis. Each mesh runs once in
  one pass a leaf (``q8_shard.CHUNK`` at its default) and once in passes
  of ``SMALL`` positions, which divides no row, so a rank's rows are read,
  reordered and written in many chunks, as at full width.
* The same updates' collectives (``CollectiveCounter.by_group``), the same
  for either chunk: no all-gather at all (no q8 row, gradient or step
  gathered), and nothing over ``pod``. An FSDP leaf's
  gradient comes by one all-to-all over ``data`` and its step goes back by
  another (one only where the rows are replicated); another leaf's step is
  summed over ``data`` by one all-reduce where each data rank updated its
  own rows. Over ``model``: two all-reduces of the rows' maxima, two of
  the int8 rows (each entry written by its one owner, zeros elsewhere),
  and one of the step where the parameter is not split over ``model``.
* The mesh train step with q8 moments and FSDP at (2, 2) (the widened
  yi-9b smoke config of ``tests/test_torch_fsdp.py``): no all-gather over
  ``data`` of a ``q``/``scale`` leaf's shape, none over ``model`` of a
  leaf split over it gathered whole, and the all-gathers over ``data`` are
  exactly the forward's and remat's FSDP gathers (no gradient gathered
  back).
* A rank's live bytes, traced on ``meta`` tensors under the fake process
  group at 16x16 (``dryrun.LiveBytes``), for one leaf of mixtral-8x22b's
  expert shape (56, 8, 6144, 16384) in bf16 placed as the rules place it
  (FSDP over ``data``, columns over ``model``): beyond the update's
  arguments, at most 8 x 4 B x N/(d m) + 2 x N/d.
"""

import math
import os

import pytest
import torch

from _torch_dist import q8_train_worker, q8_update_worker, run_ranks, smoke_cfg

MESHES = [(2, 2), (4, 1), (1, 4)]
POD = (2, 2, 2)  # (pod, data, model), on eight ranks
SMALL = 100  # positions a pass in the chunked runs: divides no 256-row
CASES = [(mesh, chunk) for chunk in (None, SMALL) for mesh in MESHES + [POD]]
#: (name, shape, spec over (data, model), seed)
LEAVES = [
    ("straddle-last", (4, 32, 40), (None, None, "model"), 1),
    ("straddle-first", (48, 40), ("model", None), 2),
    ("replicated-rows", (30, 40), (None, "model"), 3),
    ("fsdp-model", (2, 64, 48), (None, "data", "model"), 4),
    ("fsdp-model-replicated-rows", (8, 4, 36), ("data", "model", None), 5),
    ("fsdp-only", (64, 48), ("data", None), 6),
    ("fsdp-only-rows-by-mesh", (64, 40), ("data", None), 7),
    ("neither", (50, 40), (None, None), 8),
    ("neither-replicated-rows", (37, 29), (None, None), 9),
    ("one-row", (10, 12), (None, "model"), 10),
]


def case_id(case) -> str:
    mesh, chunk = case
    name = "x".join(map(str, mesh))
    name = name if len(mesh) == 2 else f"pod{name}"
    return name if chunk is None else f"{name}-chunk{chunk}"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def q8_ranks(tmp_path_factory):
    """``{(mesh, chunk): [each rank's {leaf name: [each update's result]}]}``."""
    out = {}
    for world in (4, 8):
        cases = [c for c in CASES if math.prod(c[0]) == world]
        got = run_ranks(world, q8_update_worker, ([(m, c, LEAVES) for m, c in cases],),
                        tmp_path_factory.mktemp(f"q8-{world}"))
        ranks = [torch.load(os.path.join(got, f"q8-rank{r}.pt"), weights_only=False)
                 for r in range(world)]
        for mesh, chunk in cases:
            out[mesh, chunk] = [{name: res[mesh, chunk, name] for name, *_ in LEAVES}
                                for res in ranks]
    return out


def rows(shape) -> int:
    return -(-math.prod(shape) // 256)


def straddles(shape, spec, m: int) -> bool:
    """Whether a leaf's 256-blocks straddle its ``model`` shards."""
    if m == 1 or "model" not in spec:
        return False
    d = spec.index("model")
    run = shape[d] // m * math.prod(shape[d + 1:])
    return run % 256 != 0


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_q8_update_on_a_ranks_rows_is_the_whole_leafs(q8_ranks, case):
    (d, m), chunk = case[0][-2:], case[1]
    if m > 1:
        assert any(straddles(s, spec, m) for _, s, spec, _ in LEAVES)
    if d > 1:
        assert any("data" in spec for _, _, spec, _ in LEAVES)
        assert any(rows(s) % d for _, s, _, _ in LEAVES)
        assert any(rows(s) % d == 0 and "data" in spec for _, s, spec, _ in LEAVES)
    for r, got in enumerate(q8_ranks[case]):
        if chunk is not None:  # many passes on every rank, an FSDP leaf's too
            owned = {name: got[name][0]["owned"] for name, *_ in LEAVES}
            assert max(owned.values()) > 4 * chunk, (r, owned)
            if d > 1:
                assert max(owned[name] for name, _, spec, _ in LEAVES
                           if "data" in spec) > 4 * chunk, (r, owned)
        for name, *_ in LEAVES:
            for step, res in enumerate(got[name]):
                bad = [k for k, same in res["same"].items() if not same]
                assert not bad, f"{case} {name} rank {r} update {step + 1}: {bad} differ"


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_q8_update_gathers_no_rows_and_no_whole_gradient(q8_ranks, case):
    d, m = case[0][-2:]
    for r, got in enumerate(q8_ranks[case]):
        for name, shape, spec, _ in LEAVES:
            split = d > 1 and rows(shape) % d == 0
            fsdp = d > 1 and "data" in spec
            on_model = m > 1 and "model" in spec
            for res in got[name]:
                what = (case, name, r, res["calls"])
                calls = res["calls"]
                assert not res["gathered"], what  # no row, gradient or step gathered
                if fsdp:  # the gradient there and the step back, by all-to-all
                    assert calls[("data", "all-to-all")] == (2 if split else 1), what
                    assert ("data", "all-reduce") not in calls, what
                else:  # the step summed over data where each rank updated its rows
                    assert calls.get(("data", "all-reduce"), 0) == split, what
                    assert ("data", "all-to-all") not in calls, what
                if m > 1:  # 2 rows' maxima, 2 moments' int8 rows, and the step
                    # where the parameter is not split over model
                    assert calls[("model", "all-reduce")] == 4 + (not on_model), what
                assert sum(calls.values()) == sum(v for (a, _), v in calls.items()
                                                  if a in ("data", "model")), what


def test_mesh_train_step_with_q8_gathers_no_rows(tmp_path):
    from test_torch_fsdp import CONFIGS, fsdp_blocks

    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.state import make_abstract_state, state_shardings
    from repro_torch.tree import leaves_with_paths

    cfg = smoke_cfg("yi-9b", 512, **CONFIGS["yi-9b"])
    out = run_ranks(4, q8_train_worker, (cfg,), tmp_path)
    abstract = make_abstract_state(cfg, AdamWConfig(quantized_moments=True))
    sh = state_shardings(abstract, {"data": 2, "model": 2}, cfg, fsdp=True)
    specs = {p: s.spec for p, s in leaves_with_paths(sh["params"])}
    q8_rows = {tuple(t.shape) for p, t in leaves_with_paths(abstract["opt"])
               if p.endswith(("/q", "/scale"))}
    whole = set()  # a model-split leaf (or block) gathered whole, as tp.gather fills it
    for path, t in leaves_with_paths(abstract["params"]):
        if "model" in specs[path]:
            dim = specs[path].index("model")
            for s in (tuple(t.shape), tuple(t.shape[1:])) if path.startswith("blocks/") \
                    else (tuple(t.shape),):
                k = dim - (len(t.shape) - len(s))
                if k >= 0:
                    whole.add((s[k], *s[:k], *s[k + 1:]))
    blocks = len(fsdp_blocks(cfg, (2, 2))) * cfg.n_blocks * 2  # the forward and remat
    outer = sum(1 for p, s in specs.items() if "data" in s and not p.startswith("blocks/"))
    assert blocks > 0 and q8_rows
    for r in range(4):
        got = torch.load(os.path.join(out, f"q8-train-rank{r}.pt"), weights_only=False)
        data = [s for axis, s in got["gathered"] if axis == "data"]
        assert not q8_rows & set(data), (r, q8_rows & set(data))
        assert not [s for axis, s in got["gathered"] if axis == "model" and s in whole], r
        # the forward's FSDP gathers only: no gradient gathered back over data
        assert got["calls"][("data", "all-gather")] == blocks + outer, (r, got["calls"])
        assert got["calls"][("data", "all-to-all")] > 0, r


def test_q8_update_live_bytes_at_16x16():
    from repro_torch.distributed.sharding import NamedSharding
    from repro_torch.launch.dryrun import LiveBytes
    from repro_torch.launch.mesh import fake_process_group, make_production_mesh
    from repro_torch.optim import q8_shard
    from repro_torch.optim.adamw import AdamWConfig

    shape = (56, 8, 6144, 16384)  # mixtral-8x22b's w_up, stacked
    N, d, m = math.prod(shape), 16, 16
    R = rows(shape)
    opt = AdamWConfig(quantized_moments=True)
    with fake_process_group(d * m):
        mesh = make_production_mesh(device_type="cpu")
        p_spec = (None, None, "data", "model")  # the rules' FSDP and per-expert TP
        sh = NamedSharding(mesh, p_spec)
        qs = NamedSharding(mesh, ("data", None))
        assert R % d == 0
        p = sh.place_meta(torch.empty(shape, dtype=torch.bfloat16, device="meta"))
        g = torch.empty(sh.local_shape(shape), dtype=torch.bfloat16, device="meta")

        def q8():
            return {"q": qs.place_meta(torch.empty((R, 256), dtype=torch.int8, device="meta")),
                    "scale": qs.place_meta(torch.empty((R, 1), dtype=torch.float32,
                                                       device="meta"))}

        m_, v_ = q8(), q8()
        scalars = [torch.empty((), device="meta") for _ in range(4)]
        with LiveBytes() as live:
            live.hold([p, g, *m_.values(), *v_.values(), *scalars])
            held = live.now
            q8_shard.update_leaf(p, g, m_, v_, *scalars, opt)
    beyond = live.peak - held
    bound = 8 * 4 * N // (d * m) + 2 * N // d
    assert 0 < beyond <= bound, (beyond, bound)
