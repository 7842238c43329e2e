"""The port's static analysis (``repro_torch.analysis``) on the CPU: each
checker flags a seeded violation with exactly its rule and passes the
port's own tree clean, and the parts that carry over from the reference
(``repro.analysis``) give the same answers: the findings document, the
repo-rule linter's RL000/RL003/RL004, and the tiny pair's prefill state
that the round subjects are built from.

The round audit runs on fake CUDA tensors; the checks that need the card
(runtime register and shared-memory counts, the sync debug mode, the
allocator and the profiler's copies) run in ``chip_smoke.py`` phase 29.
"""
import ast
import json
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.analysis import findings as jfindings
from repro.analysis import repolint as jrepolint
from repro.analysis.jaxpr_audit import _tiny_models as j_tiny_models
from repro.core.speculative import SDConfig as JSDConfig
from repro.core.speculative import _prefill_state as j_prefill_state
from repro_torch.analysis import (AuditSubject, Finding, FindingSet,
                                  InstanceRecord, RULES, explain, lint_file,
                                  lint_instance, lint_plan, run_kernel_lint,
                                  run_repolint, run_round_audit, run_sentinel)
from repro_torch.analysis import findings as tfindings
from repro_torch.analysis import kernel_lint as kl
from repro_torch.analysis import recompile as rc
from repro_torch.analysis import round_audit as ra
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.kernels import distill_loss as dk
from repro_torch.kernels import flash_decode as fk
from repro_torch.kernels import quant_matmul as qk
from repro_torch.kernels import tree_attention as tk
from repro_torch.kernels.launch import Launch, LaunchPlan
from repro_torch.spectree.tree import TreeSpec

ROOT = Path(__file__).resolve().parents[1]


def _rules(findings):
    return sorted({f.rule for f in findings})


@pytest.fixture(scope="module")
def subjects():
    return ra.build_audit_subjects()


# ---------------------------------------------------------------- repolint

def _lint_fixture(tmp_path, rel, source, lint=lint_file):
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(source)
    return lint(path, tmp_path)


@pytest.mark.parametrize("rel,source,want", [
    # RL001: host conversions in a round module, one finding each
    ("repro_torch/core/sampling.py",
     "def f(x, y):\n    return float(x) + y.item() + len(x.tolist())\n",
     ["RL001"] * 3),
    ("repro_torch/kernels/ops.py", "def f(x):\n    return x.cpu().numpy()\n",
     ["RL001"] * 2),
    # a host driver in a round module, a constant, an out-of-scope module
    ("repro_torch/core/speculative.py",
     "def run_rounds(x):\n    return x.cpu().numpy()\n", []),
    ("repro_torch/models/moe.py", "def f():\n    return int(3.5)\n", []),
    ("repro_torch/experiments/pipeline.py",
     "def f(x):\n    return float(x)\n", []),
    # RL002: host syncs outside the allowlist, and inside it
    ("repro_torch/serving/scheduler.py",
     "def f(x):\n    return x.cpu()\n", ["RL002"]),
    ("repro_torch/models/layers.py",
     "import torch\ndef f():\n    torch.cuda.synchronize()\n", ["RL002"]),
    ("repro_torch/serving/continuous.py",
     "import torch\ndef f(x, ev):\n    ev.synchronize()\n"
     "    return x.cpu().numpy()\n", []),
    ("repro_torch/core/speculative.py",
     "import torch\ndef sync(d):\n    torch.cuda.synchronize(d)\n", []),
    # RL003
    ("repro_torch/util.py", "_REG = {}\ndef register(k, v):\n    _REG[k] = v\n",
     ["RL003"]),
    ("repro_torch/util.py", "_T = {'a': 1}\ndef get(k):\n    return _T[k]\n",
     []),
    # RL004
    ("repro_torch/cfg.py", "from dataclasses import dataclass\n@dataclass\n"
     "class FooConfig:\n    x: int = 1\n", ["RL004"]),
    ("repro_torch/cfg.py", "from dataclasses import dataclass\n"
     "@dataclass(frozen=True)\nclass FooConfig:\n    x: int = 1\n", []),
    # RL000: a suppression needs its reason
    ("repro_torch/core/sampling.py",
     "def f(x):\n    return float(x)  # repolint: ignore[RL001]\n", ["RL000"]),
    ("repro_torch/core/sampling.py",
     "def f(x):\n    return float(x)  # repolint: ignore[RL001] host math\n",
     []),
])
def test_repolint_seeded(tmp_path, rel, source, want):
    """Each seeded source yields exactly its rule, once per violation."""
    out = _lint_fixture(tmp_path, rel, source)
    assert [f.rule for f in out] == want, [f.format() for f in out]


def test_repolint_clean_tree():
    fs = run_repolint()
    assert fs.findings == [], fs.format()
    assert fs.stats["files"] > 90


RL_PARITY_SOURCE = '''\
from dataclasses import dataclass

_REG = {}
_OK = []  # repolint: ignore[RL003] a registry with its reason
_BARE = set()  # repolint: ignore[RL003]
_CONST = (1, 2)


def register(k, v):
    _REG[k] = v
    _OK.append(v)
    _BARE.add(k)


@dataclass
class FooConfig:
    x: int = 1


@dataclass(frozen=True)
class BarConfig:
    y: int = 2


@dataclass
class LooseConfig:  # repolint: ignore[RL004] kept mutable on purpose
    z: int = 3
'''


def test_repolint_matches_reference_rl000_rl003_rl004(tmp_path):
    """The rules that carry over unchanged report the same (rule, line)
    pairs as the reference's lint_file on the same source."""
    def pairs(out):
        return sorted((f.rule, int(f.location.rsplit(":", 1)[1])) for f in out
                      if f.rule in ("RL000", "RL003", "RL004"))
    port = _lint_fixture(tmp_path / "t", "repro_torch/util.py",
                         RL_PARITY_SOURCE)
    ref = _lint_fixture(tmp_path / "j", "repro/util.py", RL_PARITY_SOURCE,
                        lint=jrepolint.lint_file)
    assert pairs(port) == pairs(ref)
    assert sorted({r for r, _ in pairs(port)}) == ["RL000", "RL003", "RL004"]


def test_findings_document_matches_reference():
    """The same findings give the same JSON document from both packages."""
    rows = [dict(checker="rounds", rule="JX001", message="host copy",
                 location="chain_round", data={"count": 2}),
            dict(checker="kernel", rule="KN004", message="row", severity="warning",
                 location="tree[tiny]", data={"row_bytes": 64})]
    docs = []
    for mod in (tfindings, jfindings):
        fs = mod.FindingSet([mod.Finding(**r) for r in rows])
        docs.append(fs.to_json(extra={"checkers": {"ast": {"files": 1}}}))
    assert docs[0] == docs[1]
    doc = json.loads(docs[0])
    assert doc["num_errors"] == 1 and doc["num_warnings"] == 1


def test_no_port_module_imports_jax_or_the_reference():
    bad = []
    for path in sorted((ROOT / "src/repro_torch").rglob("*.py")) + \
            [ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                if n.split(".")[0] in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(ROOT)}: {n}")
    assert bad == []


# ------------------------------------------------------------- round audit

def test_round_audit_clean_tree(subjects):
    """Every round variant runs on fake CUDA tensors with no host
    re-entry, a stable state, its caches in place, and one dtype a leaf;
    the tree rounds record their tree attention launches."""
    fs = run_round_audit(subjects)
    assert fs.findings == [], fs.format()
    names = {s.name for s in subjects}
    assert {"chain_round", "chain_round_kv_quant", "tree_round",
            "head_chain_round", "engine_chain_round",
            "engine_tree_round"} <= names
    calls = fs.stats["kernel_calls"]
    # tree (2, 1): 2 target layers + 3 levels x 1 drafter layer
    assert calls["tree_round"] == {"tree_attention": 5}
    assert calls["engine_tree_round"] == {"tree_attention": 5}
    assert calls["chain_round"] == {}
    for subj in subjects:
        for shape, dtype, device, _ in ra.trace_round(subj).leaves_out.values():
            assert device == "cuda:0"


def test_round_state_matches_reference_prefill_shapes(subjects):
    """The chain subject's state has the shapes of the reference's prefill
    state for the same tiny config (its caches stacked over layers)."""
    jt, jd = j_tiny_models()
    key = jax.random.PRNGKey(0)
    jtp = jax.eval_shape(lambda k: jt.init(k)[0], key)
    jdp = jax.eval_shape(lambda k: jd.init(k)[0], key)
    jst = jax.eval_shape(
        partial(j_prefill_state, jd, jt, max_total=32,
                sdc=JSDConfig(gamma=2, temperature=0.0)),
        jdp, jtp, jax.ShapeDtypeStruct((2, 8), jnp.int32), key=key)
    st = next(s for s in subjects if s.name == "chain_round").state
    for name in ("tokens", "lengths", "pending"):
        assert tuple(st[name].shape) == jst[name].shape, name
    for cname in ("t_cache", "d_cache"):
        group = jst[cname]["groups"][0]
        assert len(st[cname]) == group["k"].shape[0]
        for layer in st[cname]:
            for leaf in ("k", "v", "pos"):
                assert tuple(layer[leaf].shape) == group[leaf].shape[1:]
            assert layer["k"].dtype == torch.bfloat16


def _seeded(subjects, name, wrap, new_name=None, state=None):
    base = next(s for s in subjects if s.name == name)
    return AuditSubject(new_name or f"{name}_seeded", wrap(base.fn),
                        base.state if state is None else state, base.mode,
                        base.dtype_group)


def test_jx001_item_cpu_and_mask_index(subjects):
    def wrap(fn):
        def round_fn(st):
            st["lengths"].sum().item()
            st["pending"].cpu()
            st["tokens"][st["tokens"] > 0]
            return fn(st)
        return round_fn
    subj = _seeded(subjects, "chain_round", wrap)
    fs = run_round_audit([subj])
    assert _rules(fs) == ["JX001"], fs.format()
    kinds = {f.data.get("kind") for f in fs}
    assert {"host conversion", "device-to-host copy",
            "data-dependent op"} <= kinds


def test_jx001_host_to_device_copy(subjects):
    def wrap(fn):
        def round_fn(st):
            st["lengths"] = st["lengths"] + torch.as_tensor([1, 1]).to(
                st["lengths"].device)
            return fn(st)
        return round_fn
    fs = run_round_audit([_seeded(subjects, "chain_round", wrap)])
    assert _rules(fs) == ["JX001"], fs.format()
    assert fs.findings[0].data["kind"] == "host-to-device copy"


def test_jx001_number_written_through_tensor_indices(subjects):
    """``x[idx] = -1`` on a CUDA tensor copies the -1 from the host (and
    waits for the card); a device tensor value, or a basic index, does
    not."""
    def wrap(fn):
        def round_fn(st):
            rows = torch.arange(2, device=st["lengths"].device)
            st["tokens"][rows, st["lengths"]] = -1
            st["tokens"][:, 0] = 0
            st["tokens"][rows, st["lengths"]] = st["pending"]
            return fn(st)
        return round_fn
    fs = run_round_audit([_seeded(subjects, "chain_round", wrap)])
    assert _rules(fs) == ["JX001"] and len(fs) == 1, fs.format()
    assert fs.findings[0].data["op"] == "a host value written through " \
        "tensor indices"


def test_jx002_dtype_drift(subjects):
    def wrap(fn):
        def round_fn(st):
            new, n = fn(st)
            return dict(new, lengths=new["lengths"].int()), n
        return round_fn
    fs = run_round_audit([_seeded(subjects, "chain_round", wrap)])
    assert _rules(fs) == ["JX002"], fs.format()
    assert fs.findings[0].location.endswith("['lengths']")


def test_jx003_reallocated_cache(subjects):
    def wrap(fn):
        def round_fn(st):
            new, n = fn(st)
            cache = [dict(layer) for layer in new["t_cache"]]
            cache[0]["k"] = cache[0]["k"].clone()
            return dict(new, t_cache=cache), n
        return round_fn
    fs = run_round_audit([_seeded(subjects, "chain_round", wrap)])
    assert _rules(fs) == ["JX003"], fs.format()
    assert fs.findings[0].data["leaves"] == ["['t_cache'][0]['k']"]


def test_jx004_cross_variant_dtype_flip(subjects):
    """A variant whose token buffer is int32 where the others' is int64:
    its own state is stable, the flip shows only across variants."""
    base = next(s for s in subjects if s.name == "chain_round")
    with base.mode:
        st = dict(base.state, tokens=base.state["tokens"].int())
    flip = AuditSubject("chain_round_int32", base.fn, st, base.mode)
    fs = run_round_audit([base, flip])
    assert _rules(fs) == ["JX004"], fs.format()
    assert fs.findings[0].location == "['tokens']"


def test_audit_leaves_kernel_launch_counts_alone(subjects):
    from repro_torch.kernels import ops
    before = dict(ops.LAUNCHES)
    subj = next(s for s in subjects if s.name == "tree_round")
    subj._result = None
    assert ra.trace_round(subj).kernel_calls == {"tree_attention": 5}
    assert ops.LAUNCHES == before
    assert tk.tree_attention.__module__ == "repro_torch.kernels.tree_attention"


def test_tree_tables_copied_once_per_device():
    spec = TreeSpec((2, 2))
    a, b = spec.on("cpu"), spec.on("cpu")
    assert all(a[k] is b[k] for k in a)
    assert torch.equal(a["children"], torch.as_tensor(spec.children()))
    assert spec == TreeSpec((2, 2)) and hash(spec) == hash(TreeSpec((2, 2)))


# --------------------------------------------------------------- recompile

def test_sentinel_and_transfer_audit_clean_on_tiny_engine():
    """One fetch a steady-state decode round, chain and tree, and nothing
    built or loaded over 16 further rounds; the card's checks are named as
    left out."""
    fs = run_sentinel("cpu")
    assert fs.findings == [], fs.format()
    assert fs.stats["chain_transfers"]["fetches"] == 1
    assert fs.stats["tree_transfers"]["fetches"] == 1
    assert fs.stats["tree_sentinel"]["rounds"] == rc.STEADY_ROUNDS
    assert any("RC004" in s for s in fs.stats["left_out"])


def test_rc003_extra_fetch_in_a_round():
    from repro_torch.serving import continuous
    eng = rc.tiny_engine("cpu")
    real = eng._round

    def round_fn(st):
        out = real(st)
        continuous.fetch_to_host(out[0]["lengths"])
        return out

    eng._round = round_fn
    fs = rc.audit_round_transfers(eng)
    assert _rules(fs) == ["RC003"], fs.format()
    assert fs.findings[0].data["fetches"] == 2


def test_rc001_rc002_from_watched_builds():
    watch = rc.KernelBuildWatcher()
    watch.builds += ["tree_attention", "tree_attention"]
    watch.loads += ["quant_matmul"]
    fs = rc.repeated_builds(watch)
    assert _rules(fs) == ["RC001"] and len(fs) == 1
    eng = rc.tiny_engine("cpu")
    real = eng._round

    def round_fn(st):
        from repro_torch.kernels import build
        build.build_all([])          # a no-op build: watched, not counted
        return real(st)

    eng._round = round_fn
    assert rc.run_recompile_sentinel(eng, rounds=2).findings == []


# -------------------------------------------------------------- kernel lint

def test_kernel_plans_clean_at_swept_shapes():
    fs = run_kernel_lint("cpu")
    assert fs.errors == [], fs.format()
    assert fs.stats["plans"] == fs.stats["cases"] == len(kl.build_kernel_cases())
    assert _rules(fs) in ([], ["KN004"])          # tiny rows: warnings only
    assert kl.CARD_ONLY in fs.stats["left_out"]


def test_kernel_lint_refused_shape_is_kn002():
    case = kl.KernelCase("tree_bad_hd", lambda *a: tk.tree_attention(*a),
                         (((1, 1, 2, 1, 48), torch.bfloat16),
                          ((1, 64, 1, 48), torch.bfloat16),
                          ((1, 64, 1, 48), torch.bfloat16),
                          ((1, 2, 64), torch.bool)))
    fs = run_kernel_lint("cpu", [case])
    assert _rules(fs) == ["KN002"] and "head dim 48" in fs.findings[0].message


def _plan(**kw):
    base = dict(kernel="k", library="tree_attention",
                launches=(Launch("k<1>", (4, 2, 2), 128),), query=(),
                extent=256, chunk=128, splits=2, step=64,
                buffers=(("out", (4, 8), torch.float32),), rows=(("k", 256),))
    base.update(kw)
    return LaunchPlan(**base)


@pytest.mark.parametrize("kw,rule", [
    ({}, None),
    ({"chunk": 96}, "KN002"),                               # not whole steps
    ({"extent": 300}, "KN002"),                             # misses slots
    ({"splits": 3, "extent": 256}, "KN002"),                # an empty split
    ({"launches": (Launch("k<1>", (4, 70000, 1), 128),)}, "KN002"),
    ({"launches": (Launch("k<1>", (16, 1, 1), 128, 16),)}, "KN002"),
    ({"buffers": (("part", (4, 2, 10), torch.bfloat16),)}, "KN003"),
    ({"rows": (("v", 96),)}, "KN004"),
])
def test_kn002_kn003_kn004_on_synthetic_plans(kw, rule):
    out = lint_plan(_plan(**kw), "synthetic")
    assert _rules(out) == ([] if rule is None else [rule])
    if rule == "KN004":
        assert out[0].severity == "warning"


def _record(**kw):
    base = dict(symbol="k<1>", library="tree_attention", registers=64,
                static_smem=1024, dynamic_smem=65536, local_bytes=0,
                max_threads=1024, threads=256, blocks_per_sm=2)
    base.update(kw)
    return InstanceRecord(**base)


@pytest.mark.parametrize("kw,severity", [
    ({}, None),
    ({"registers": 256, "threads": 128}, "error"),          # > 255 a thread
    ({"registers": 128, "threads": 1024}, "error"),         # > 65,536 an SM
    ({"dynamic_smem": 232_000}, "error"),                   # > 232,448 B
    ({"smem_error": 1}, "error"),                           # refused
    ({"blocks_per_sm": 0}, "error"),
    ({"threads": 512, "max_threads": 256}, "error"),
    ({"spill_stores": 8, "spill_loads": 8}, "warning"),
])
def test_kn001_on_synthetic_records(kw, severity):
    out = lint_instance(_record(**kw))
    if severity is None:
        assert out == []
    else:
        assert _rules(out) == ["KN001"]
        assert {f.severity for f in out} == {severity}


def test_launch_plans_match_the_wrappers_allocations():
    """The plans the wrappers launch from: tree attention's split state
    buffer, the quantized matmul's slice sums, each output fp32."""
    p = tk.launch_plan(4, 8, 7, 4, 128, 4096, torch.bfloat16, 132)
    assert (p.chunk, p.splits) == tk.plan(4, 8, 7, 4, 128, 4096, 2, 132)
    assert [b[0] for b in p.buffers] == ["out", "part"]
    assert p.buffers[1][1] == (4 * 8 * 28, p.splits, 130)
    assert p.launches[0].symbol == "tree_attention_mma<128>"
    assert p.launches[1].symbol == "tree_attention_combine"
    f = fk.launch_plan(1, 8, 3, 16, 300, torch.float32, 132, lambda s: 16)
    assert f.launches[0].symbol == "flash_decode_kernel<float, 16, 0, 4>"
    assert f.launches[0].cluster == f.splits
    q = qk.launch_plan(16, 4096, 4096, 4, 128, torch.bfloat16)
    assert q.splits > 1 and [b[0] for b in q.buffers] == ["out", "part"]
    assert q.launches[0].grid[2] == q.splits
    q64 = qk.launch_plan(512, 4096, 4096, 8, 0, torch.bfloat16)
    assert [b[0] for b in q64.buffers] == ["out"]
    assert q64.launches[0].threads == 512 and q64.launches[0].grid[2] == 1
    d = dk.launch_plan("loss_terms", 37, 32003, "kld")
    assert d.launches[0].symbol == "loss_terms_kernel<0>"
    assert d.buffers == (("out", (4, 37), torch.float32),)
    assert len(kl.all_instance_plans()) == 83


@pytest.mark.parametrize("B,S", [(4, 4352), (1, 4352), (4, 201)])
def test_launch_plan_of_gemma_verify_at_head_dim_256(B, S):
    """Gemma-2-9B's verify pass (Hkv 8, N 7, G 2, hd 256, bf16) launches the
    tensor-core instance that stages K and V in rings, then the combine of
    its splits from an fp32 part buffer of (B*Hkv*N*G, splits, hd + 2)."""
    p = tk.launch_plan(B, 8, 7, 2, 256, S, torch.bfloat16, 132)
    assert (p.chunk, p.splits) == tk.plan(B, 8, 7, 2, 256, S, 2, 132)
    assert p.splits > 1 and p.chunk % p.step == 0 and p.step == 64
    assert p.launches[0].symbol == "tree_attention_mma_ring<256>"
    assert p.launches[0].grid == (B * 8, 1, p.splits)
    assert p.launches[0].threads == 128
    assert p.launches[1].symbol == "tree_attention_combine"
    assert p.buffers == (("out", (B, 8, 7, 2, 256), torch.float32),
                         ("part", (B * 8 * 14, p.splits, 258), torch.float32))
    assert p.query == (7, 2, 256, 1, p.splits)


def test_ptxas_records_parse_a_report():
    log = ("ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z3fooPf\n"
           "    16 bytes stack frame, 8 bytes spill stores, 12 bytes spill "
           "loads\n"
           "ptxas info    : Used 96 registers, used 1 barriers, 2048 bytes "
           "smem, 380 bytes cmem[0]\n")
    rec = kl.ptxas_records(log)
    assert len(rec) == 1 and rec[0]["registers"] == 96
    assert (rec[0]["smem"], rec[0]["spill_stores"],
            rec[0]["spill_loads"]) == (2048, 8, 12)
    assert rec[0]["name"] in ("foo", "_Z3fooPf")
    assert kl.ptxas_report(log)[0].endswith("spills 8/12 B")


# ------------------------------------------------------------------- CLI

def test_cli_all_on_the_cpu_writes_the_findings_document(tmp_path):
    out = tmp_path / "out.json"
    assert cli_main(["--all", "--device", "cpu", "--json", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["num_errors"] == 0 and doc["device"] == "cpu"
    assert set(doc["checkers"]) == {"ast", "rounds", "kernels", "recompile"}
    for name in ("rounds", "kernels", "recompile"):
        assert doc["checkers"][name]["left_out"], name


def test_cli_needs_the_card_unless_told_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    assert cli_main(["--ast"]) == 2
    assert "--device cpu" in capsys.readouterr().err


def test_every_rule_is_explained():
    assert sorted(RULES) == sorted(
        [f"RL00{i}" for i in range(5)] + [f"{p}00{i}" for p in ("JX", "RC", "KN")
                                          for i in range(1, 5)])
    for rule in RULES:
        assert explain(rule).startswith(f"{rule}: ")
    assert cli_main(["--explain", "RC002"]) == 0
    assert isinstance(Finding("kernel", "KN001", "m"), Finding)
    assert len(FindingSet([Finding("kernel", "KN001", "m")]).errors) == 1
