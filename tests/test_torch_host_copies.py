"""The port's copies of the JAX package's host layers.

The port imports nothing of ``k_llms_tpu``, so it carries its own copies of
the JAX-free host modules. Each copy must equal the reference's source apart
from import lines and the edits documented below (per module): doc paths to
the reference SDK written without the machine path, the reference's
tracking tags dropped, the package's own name, the native build into ``_build/``, in the four grammar-constraint
modules the device half (from its "Device side" marker on), which the port
rewrites in torch, and in the serving layer (failpoints, retry, tenancy,
the scheduler, the supervisor, the replica set, the latency histograms) the
paged-attention drill's target, the card's limits on healing a hang, and
the default member backend; in the streaming and HTTP serving layer (the
tracer, flight recorder and Prometheus exposition, the job store and batch
lane, the ASGI app, its server and entry point, the fake backend, the
resources) the port's backend names and profiler.

Then a sample of the JAX package's own test vectors (``test_alignment``,
``test_translit``, ``test_native``, and TRUTH_DOCS consolidation) runs
through both packages with equal results.
"""

import os
import re

import numpy as np
import pytest

from fixtures.unidecode_vectors import DIVERGENT_VECTORS, PARITY_VECTORS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF, PORT = os.path.join(REPO, "k_llms_tpu"), os.path.join(REPO, "k_llms_tpu_torch")

#: module -> documented (reference text, port text) edits, applied to the
#: reference after the generic rewrites of ``_normalise``.
EDITS = {
    "native/__init__.py": [
        ("``make`` on demand", "the host C++ compiler on demand"),
        (
            '_LIB_PATH = os.path.join(_DIR, "libkllms_native.so")\n',
            '_SOURCES = [os.path.join(_DIR, "levenshtein.cpp"), os.path.join(_DIR, "hungarian.cpp")]\n'
            "# Built at first use into the package's ignored build directory, never\n"
            "# beside the sources.\n"
            '_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")\n'
            '_LIB_PATH = os.path.join(_BUILD_DIR, "libkllms_native.so")\n',
        ),
        (
            '    """Compile the shared library in-place. Returns True on success."""\n',
            '    """Compile the shared library into the build directory. Returns True on\n'
            '    success."""\n',
        ),
        ("    try:\n", "    try:\n        os.makedirs(_BUILD_DIR, exist_ok=True)\n"
                     '        tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"\n'),
        ('            ["make", "-C", _DIR],\n',
         '            [os.environ.get("CXX", "g++"), "-O3", "-fPIC", "-std=c++17",\n'
         '             "-shared", "-o", tmp, *_SOURCES],\n'),
        ("        return os.path.exists(_LIB_PATH)\n",
         "        os.replace(tmp, _LIB_PATH)\n        return True\n"),
    ],
    "engine/json_constraint.py": [
        ("run inside the jitted decode loop", "run inside the decode loop"),
        ("carried through the\n``lax.while_loop``. Per step:", "carried through the\ndecode loop. Per step:"),
        ("table lookup — no Python control flow in the\ncompiled program.",
         "table lookup — no Python control flow and no\nhost sync in the per-step ops."),
    ],
    "engine/token_constraint.py": [
        ("with a short\n  ``fori_loop`` (so the huge [S, V] next-state table never exists on device).",
         "with a short\n  loop over byte columns (so the huge [S, V] next-state table never exists on\n"
         "  device)."),
    ],
    "engine/grammar.py": [
        ("  Cache stats surface as ``kllms_grammar_cache_*`` gauges on ``/metrics``.\n",
         "  Cache stats surface through :func:`grammar_cache_stats`.\n"),
        ("no host work per step.  The jitted\ncallers (`engine._get_decode_loop`, "
         "`ContinuousDecodeLoop._grammar_programs`)\nkeep state advance in the step function; "
         "kllms-check's host-sync-hot-path rule\npins ``grammar_mask_logits`` / "
         "``grammar_advance`` sync-free.\n",
         "no host work per step.  They are\ntorch ops on the tables' device that never read a "
         "value back to the host, so\nthe engine's decode loop (``engine._decode``) masks and "
         "advances every step\nwithout a sync.\n"),
    ],
}

#: The serving layer's copies: what differs on the card.
EDITS.update({
    "reliability/failpoints.py": [
        ("                           action forces the counted degrade from the fused\n"
         "                           Pallas kernel to the XLA reference (recording\n"
         "                           ``kernel.paged_attn_fallback.failpoint``),\n"
         "                           exercising the kernel-unavailable path without\n"
         "                           leaving the TPU build\n",
         "                           action sends one CPU launch to the plain version\n"
         "                           (recording ``kernel.paged_attn_fallback.failpoint``)\n"
         "                           and fails one card launch with a typed 503\n"
         "                           (recording ``kernel.paged_attn_unavailable.failpoint``):\n"
         "                           nothing on a card gives way to the plain version\n"),
    ],
    # The docstring's opening without the project's history; the limit of
    # in-process healing on a card, and the stream the launch threads use.
    "reliability/supervisor.py": [
        ("PRs 1-2 hardened the *request* path", "Deadlines, retries and breakers harden the *request* path"),
        ("the engine: at most one launch/rebuild is ever active.\n",
         "the engine: at most one launch/rebuild is ever active.\n"
         "\n"
         "On a CUDA card the watchdog heals host-side hangs: the ``hang`` failpoint, a\n"
         "stuck host thread, a deadlock. A kernel truly wedged on the card cannot be\n"
         "killed from the process: the abandoned launch thread keeps the old engine\n"
         "(and its weights on the card) until the kernel returns, and the replay\n"
         "queues behind it on the same stream, so ``max_rebuilds`` then ends in\n"
         "STOPPED and typed 503s. Launch threads issue their work on the card's\n"
         "legacy default stream, as the scheduler's worker does, which keeps the\n"
         "split-reduction kernels' arrival semaphores in stream order.\n"),
    ],
    # The port's backend is "cuda".
    "reliability/replicas.py": [
        ('{"backend": "tpu", "id": "west", **kwargs}', '{"backend": "cuda", "id": "west", **kwargs}'),
        ('name = spec.pop("backend", "tpu")', 'name = spec.pop("backend", "cuda")'),
    ],
})

#: The streaming, observability and HTTP serving copies: the port's backend
#: names and its profiler.
EDITS.update({
    "serving/__main__.py": [
        ("--backend tpu --model tiny --port 8000", "--backend cuda --model tiny --port 8000"),
        ('    p.add_argument("--backend", default="tpu", choices=["tpu", "fake"])\n',
         '    p.add_argument("--backend", default="cuda", choices=["cuda", "fake"])\n'
         '    p.add_argument(\n'
         '        "--device", default=None,\n'
         '        help="where the cuda backend runs: the CUDA card by default (the server "\n'
         '             "fails to start without one); \'cpu\' runs the plain PyTorch versions",\n'
         '    )\n'),
        ('        ("continuous_width", "continuous_width"),\n',
         '        ("continuous_width", "continuous_width"),\n        ("device", "device"),\n'),
    ],
    "serving/app.py": [
        ("on-demand jax.profiler capture", "on-demand torch.profiler capture"),
    ],
    "observability/trace.py": [
        ("guarded by a lockcheck leaf lock", "guarded by a leaf lock"),
    ],
    "resources/completions.py": [
        ("# TpuBackend attaches engine_stats", "# CudaBackend attaches engine_stats"),
    ],
})

#: The grammar-constraint modules: only the host half is a copy.
DEVICE_MARKERS = {
    "engine/json_constraint.py": "# --- device side",
    "engine/schema_constraint.py": "# --- device side",
    "engine/token_constraint.py": "# Device side",
    "engine/grammar.py": "# Device side",
}

#: Modules of the copied directories that the port rewrites rather than
#: copies: the device consensus runs torch and the Levenshtein kernel where
#: the reference runs jitted JAX.
REWRITTEN = {"consensus/device.py"}

COPIED = sorted(
    [f"consensus/{f}" for f in os.listdir(os.path.join(PORT, "consensus"))
     if f.endswith(".py") and f"consensus/{f}" not in REWRITTEN]
    + [f"types/{f}" for f in os.listdir(os.path.join(PORT, "types")) if f.endswith(".py")]
    + ["native/__init__.py", "native/levenshtein.cpp", "native/hungarian.cpp",
       "reliability/deadline.py", "engine/tokenizer.py", "reliability/failpoints.py",
       "reliability/retry.py", "reliability/tenancy.py", "reliability/supervisor.py",
       "reliability/replicas.py", "engine/scheduler.py", "observability/histograms.py",
       "observability/__init__.py", "observability/flight.py", "observability/prometheus.py",
       "observability/trace.py", "reliability/jobstore.py", "backends/fake.py",
       "resources/completions.py", "serving/__init__.py", "serving/__main__.py",
       "serving/app.py", "serving/batch.py", "serving/server.py", "serving/sse.py"]
    + [f"keyalign/{f}" for f in ("__init__.py", "align.py", "fuzzy.py", "selection.py")]
    + list(DEVICE_MARKERS)
)


def _drop_imports(text: str) -> str:
    """Every import statement removed (multi-line ``from x import (...)`` too)."""
    out, in_import = [], False
    for line in text.splitlines(keepends=True):
        stripped = line.strip()
        if in_import:
            in_import = not stripped.endswith(")")
            continue
        if re.match(r"(from \S+ import |import \S)", stripped):
            in_import = stripped.endswith("(")
            continue
        out.append(line)
    return "".join(out)


def _normalise(ref: str) -> str:
    """The rewrites every copy shares: reference-SDK doc paths without the
    machine path, tracking tags such as ``(WORD 8)``, ``(WORD r3 #3)`` or
    ``(PR 2)`` dropped, the package's own name."""
    ref = re.sub(r"/[\w./-]*?/(k_llms/)", r"\1", ref)
    ref = re.sub(r"`/[\w./-]*?/(README\w*\.md)", r"`k-LLMs \1", ref)
    ref = re.sub(r" \([A-Z]{5,} (?:\d+(?: satellite)?|r\d+ #\d+)\)", "", ref)
    ref = re.sub(r" \(PR \d+\)", "", ref)
    ref = re.sub(r" \(the PR [\d/]+ pattern\)", "", ref)
    return re.sub(r"\bk_llms_tpu(?=[./])", "k_llms_tpu_torch", ref)


def _host_half(name: str, text: str) -> str:
    marker = DEVICE_MARKERS.get(name)
    return text if marker is None else text[: text.index(marker)]


@pytest.mark.parametrize("name", COPIED)
def test_copy_equals_reference_apart_from_imports_and_documented_edits(name):
    with open(os.path.join(REF, name), encoding="utf-8") as f:
        ref = _normalise(f.read())
    with open(os.path.join(PORT, name), encoding="utf-8") as f:
        port = f.read()
    for old, new in EDITS.get(name, []):
        assert old in ref, f"{name}: documented edit no longer matches the reference: {old!r}"
        ref = ref.replace(old, new, 1)
    ref, port = (_drop_imports(_host_half(name, t)) for t in (ref, port))
    assert port == ref


def test_incremental_detok_is_a_copy():
    """``backends/cuda.py::_IncrementalDetok`` is the JAX backend's class."""
    def source(path, cls, end):
        with open(path, encoding="utf-8") as f:
            text = f.read()
        return text[text.index(f"class {cls}"): text.index(end)]

    ref = source(os.path.join(REF, "backends", "tpu.py"), "_IncrementalDetok", "class TpuBackend")
    port = source(os.path.join(PORT, "backends", "cuda.py"), "_IncrementalDetok", "class HbmMemoryModel")
    assert port == ref


def test_every_copied_module_is_listed():
    """A copied module added to the port joins the list above."""
    listed = set(COPIED)
    for sub in ("consensus", "types"):
        for f in os.listdir(os.path.join(PORT, sub)):
            if f.endswith(".py") and f"{sub}/{f}" not in REWRITTEN:
                assert f"{sub}/{f}" in listed


# --- the JAX package's vectors through both copies ---------------------------

@pytest.mark.parametrize("inp,expected", PARITY_VECTORS[::4] + [(v[0], v[2]) for v in DIVERGENT_VECTORS[:4]])
def test_translit_vectors_equal(inp, expected):
    from k_llms_tpu.consensus.translit import transliterate as jax_translit
    from k_llms_tpu_torch.consensus.translit import transliterate

    assert transliterate(inp) == jax_translit(inp) == expected


def test_native_levenshtein_and_assignment_equal():
    import random
    import string

    from k_llms_tpu import native as jnative
    from k_llms_tpu_torch import native as tnative

    assert tnative.native_available()
    rng = random.Random(42)
    alphabet = string.ascii_lowercase + "éß日本"
    for _ in range(100):
        a = "".join(rng.choices(alphabet, k=rng.randint(0, 30)))
        b = "".join(rng.choices(alphabet, k=rng.randint(0, 30)))
        d = jnative.levenshtein_distance(a, b)
        assert tnative.levenshtein_distance(a, b) == d == tnative._levenshtein_py(a, b)
    nrng = np.random.default_rng(7)
    for _ in range(50):
        c = nrng.random((nrng.integers(1, 10), nrng.integers(1, 10)))
        r1, c1 = tnative.linear_sum_assignment(c)
        r2, c2 = jnative.linear_sum_assignment(c)
        np.testing.assert_array_equal(r1, r2)
        np.testing.assert_array_equal(c1, c2)


ALIGNMENT_CASES = [
    [["apple", "banana"], ["apple", "banana"], ["apple", "banana"]],
    [["apple pie", "banana bread"], ["banana bread", "apple pie"]],
    [["alpha", "beta", "gamma"], ["alpha", "gamma"], ["beta", "alpha", "gamma"]],
    [[], [], []],
]


@pytest.mark.parametrize("lists", ALIGNMENT_CASES)
def test_alignment_vectors_equal(lists):
    from k_llms_tpu.consensus.alignment import lists_alignment as jax_align
    from k_llms_tpu.consensus.similarity import SimilarityScorer as JaxScorer
    from k_llms_tpu_torch.consensus.alignment import lists_alignment
    from k_llms_tpu_torch.consensus.similarity import SimilarityScorer

    got = lists_alignment(lists, SimilarityScorer(method="levenshtein").generic,
                          min_support_ratio=0.5)
    ref = jax_align(lists, JaxScorer(method="levenshtein").generic, min_support_ratio=0.5)
    assert got == ref


@pytest.mark.parametrize("doc", ["invoice", "purchase_order", "profile"])
def test_truth_docs_consolidation_equal(doc):
    """Perturbed copies of a TRUTH_DOCS document consolidate to the same
    consensus and likelihoods through both packages' host consensus."""
    import copy
    import json

    from k_llms_tpu.consensus.recursion import consensus_dict as jax_consensus_dict
    from k_llms_tpu.consensus.settings import ConsensusSettings as JaxSettings
    from k_llms_tpu.consensus.similarity import SimilarityScorer as JaxScorer
    from k_llms_tpu.utils.quality import TRUTH_DOCS
    from k_llms_tpu_torch.consensus.recursion import consensus_dict
    from k_llms_tpu_torch.consensus.settings import ConsensusSettings
    from k_llms_tpu_torch.consensus.similarity import SimilarityScorer

    truth = TRUTH_DOCS[doc]
    samples = [copy.deepcopy(truth) for _ in range(4)]
    first = next(iter(truth))
    samples[1][first] = "changed" if isinstance(truth[first], str) else truth[first]
    samples[3] = {k: v for k, v in list(truth.items())[:-1]}
    got = consensus_dict(samples, ConsensusSettings(), SimilarityScorer(method="levenshtein"))
    ref = jax_consensus_dict(samples, JaxSettings(), JaxScorer(method="levenshtein"))
    assert json.dumps(got, sort_keys=True, default=str) == json.dumps(ref, sort_keys=True, default=str)


# --- the key aligner (keyalign/) through both packages -------------------------

def _keyalign_family(seed):
    """Perturbed product extractions (the JAX package's test vectors):
    prices jittered, quantities bumped, names upper-cased, records shuffled
    and sometimes one dropped."""
    import copy
    import random

    rng = random.Random(seed)
    skus = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta"]
    base, seen = [], set()
    for _ in range(rng.randint(2, 5)):
        sku = rng.choice(skus)
        if sku in seen:
            continue
        seen.add(sku)
        base.append({"sku": sku, "name": rng.choice(skus) + " item",
                     "price": round(rng.uniform(1, 50), rng.choice([2, 3])),
                     "qty": rng.randint(1, 9),
                     "meta": {"cat": rng.choice(["tools", "toys", "food"]), "rank": rng.randint(1, 100)}})
    out = [{"products": base}]
    for _ in range(rng.randint(1, 3)):
        e = copy.deepcopy(base)
        for rec in e:
            if rng.random() < 0.4:
                rec["price"] = round(rec["price"] + rng.uniform(-0.004, 0.004), 4)
            if rng.random() < 0.2:
                rec["qty"] += 1
            if rng.random() < 0.2:
                rec["name"] = rec["name"].upper()
        rng.shuffle(e)
        if rng.random() < 0.3 and e:
            e.pop()
        out.append({"products": e})
    return out


@pytest.mark.parametrize("seed", range(6))
def test_keyalign_vectors_equal(seed):
    """Key selection (plain and fuzzy) and ``recursive_align`` give the same
    results through both packages' key aligners."""
    import copy

    from k_llms_tpu import keyalign as jax_keyalign
    from k_llms_tpu_torch import keyalign

    family = _keyalign_family(seed)

    def outcome(mod, fn):
        try:
            return fn(mod)
        except ValueError as e:
            return ("error", str(e))

    def selection(mod):
        r = mod.select_best_keys(copy.deepcopy(family))
        return [(tuple(m.path), m.score_tuple) if m else None
                for m in (r.best_single, r.best_composite)]

    def fuzzy(mod):
        r = mod.select_best_keys_with_fuzzy_fallback(copy.deepcopy(family))
        return r.chosen, None if r.fuzzy_best is None else (tuple(r.fuzzy_best.path),
                                                            r.fuzzy_best.score_tuple)

    for fn in (selection, fuzzy):
        assert outcome(keyalign, fn) == outcome(jax_keyalign, fn)
    values = [{"doc": {"items": e["products"], "status": "open"}} for e in family]
    got = keyalign.recursive_align(copy.deepcopy(values), "levenshtein", 0.5)
    ref = jax_keyalign.recursive_align(copy.deepcopy(values), "levenshtein", 0.5)
    assert list(got[0]) == list(ref[0]) and got[1] == ref[1]


def test_key_aligner_consolidation_equals_jax():
    """``aligner="key"`` consolidates through the port's copy exactly as the
    JAX package does."""
    import json

    from k_llms_tpu.consensus.consolidation import consolidate_chat_completions as jax_consolidate
    from k_llms_tpu.consensus.settings import ConsensusSettings as JaxSettings
    from k_llms_tpu.consensus.similarity import SimilarityScorer as JaxScorer
    from k_llms_tpu.types import ChatCompletion as JaxChatCompletion
    from k_llms_tpu_torch.consensus.consolidation import consolidate_chat_completions
    from k_llms_tpu_torch.consensus.settings import ConsensusSettings
    from k_llms_tpu_torch.consensus.similarity import SimilarityScorer
    from k_llms_tpu_torch.types import ChatCompletion

    payload = {"id": "c", "created": 0, "model": "m", "object": "chat.completion", "choices": [
        {"finish_reason": "stop", "index": i,
         "message": {"role": "assistant", "content": json.dumps(e)}}
        for i, e in enumerate(_keyalign_family(3))]}
    got = consolidate_chat_completions(ChatCompletion.model_validate(payload),
                                       SimilarityScorer(method="levenshtein"),
                                       ConsensusSettings(aligner="key"))
    ref = jax_consolidate(JaxChatCompletion.model_validate(payload),
                          JaxScorer(method="levenshtein"), JaxSettings(aligner="key"))
    assert got.choices[0].message.content == ref.choices[0].message.content
    assert got.likelihoods == ref.likelihoods
