"""``parse()`` on the windowed and softcapped families, port against JAX.

Gemma-2 (alternating windows of 8, attention and logit softcaps) and
Mistral (a window of 8) at tiny widths in fp32, served through the user's
entry point of each package: the port's ``KLLMs(backend="cuda",
device="cpu")`` and the JAX package's ``KLLMs(backend="tpu")``, on the same
seeded weights (``params_from_numpy`` of the JAX ``init_params``), the same
grammar-constrained, sampled, logit-biased request, on the paged layout
(whose decode these families run through the reference attention in both
packages) and on the dense one. Every sample's tokens and finish reason are
equal, the consensus' ``parsed`` is equal, its likelihoods within 1e-6, and
the per-token logprobs within the parity harness's 1e-5."""

import json
from typing import Literal

import jax
import numpy as np
import pytest
from pydantic import BaseModel, Field

from conftest import shared_params
from k_llms_tpu import KLLMs as JaxKLLMs
from k_llms_tpu.backends.tpu import TpuBackend
from k_llms_tpu.engine.engine import LocalEngine as JaxEngine
from k_llms_tpu.models import config as jax_config
from k_llms_tpu_torch import KLLMs
from k_llms_tpu_torch.backends.cuda import BackendConfig, CudaBackend
from k_llms_tpu_torch.engine.engine import LocalEngine
from k_llms_tpu_torch.models import config as torch_config
from k_llms_tpu_torch.models import llama

GEMMA = dict(sliding_window=8, sliding_window_layers="alternating", act="gelu",
             norm_offset=True, embed_scale=True, post_block_norms=True, attn_softcap=50.0,
             logit_softcap=30.0, query_scale=16.0 ** -0.5)
MISTRAL = dict(sliding_window=8)
# (family, depth): Gemma-2 at two depths (one and two local/global pairs).
CASES = [("gemma", 2), ("gemma", 4), ("mistral", 2)]


class Record(BaseModel):
    """The smoke's family schema: an unbounded string, so at a tiny size
    most samples reach ``max_tokens`` and the consensus is not a Record."""
    name: str
    count: int


class InvoiceStatus(BaseModel):
    """The smoke's 8B schema: bounded, so every sample ends in ``stop``."""
    status: Literal["paid", "unpaid", "overdue"]
    paid_in_full: bool
    note: str = Field(max_length=16)


# The smoke's parse requests at a tiny size: a logit bias on the printable
# bytes, sampled, grammar-constrained by default.
REQUESTS = {
    "record": dict(messages=[{"role": "user", "content": "Invoice 2024-0117 lists 12 widgets "
                                                         "from Acme. Extract the record."}],
                   response_format=Record, max_tokens=40),
    "invoice": dict(messages=[{"role": "user", "content": "Invoice 2024-0117 is 12 days past "
                                                          "due and nothing was paid. Extract "
                                                          "its status."}],
                    response_format=InvoiceStatus, max_tokens=72),
}
SAMPLING = dict(n=4, temperature=0.8, seed=17, logprobs=True,
                logit_bias={str(t): 10.0 for t in range(32, 127)})


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}.{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}[{i}]"))
        return out
    return {prefix: tree}


@pytest.fixture(scope="module", params=CASES, ids=[f"{f}{d}" for f, d in CASES])
def case(request):
    family, depth = request.param
    name = f"tiny-{family}{depth}-parse"
    overrides = dict(GEMMA if family == "gemma" else MISTRAL, name=name, num_layers=depth)
    jcfg = jax_config.get_config("tiny").with_(**overrides)
    cfg = torch_config.get_config("tiny").with_(**overrides)
    jparams = shared_params(jcfg, 0)
    return name, jcfg, cfg, jparams, llama.params_from_numpy(jax.device_get(jparams), cfg)


@pytest.mark.parametrize("fmt,layout", [("record", "paged"), ("record", "dense"),
                                        ("invoice", "paged")])
def test_parse_equals_jax(case, fmt, layout, monkeypatch):
    name, jcfg, cfg, jparams, params = case
    # Registered for this test only: the registries must stay equal.
    monkeypatch.setitem(jax_config._REGISTRY, name, jcfg)
    monkeypatch.setitem(torch_config._REGISTRY, name, cfg)
    jeng = JaxEngine(jcfg, params=jparams, use_mesh=False, kv_layout=layout, kv_page_size=8)
    teng = LocalEngine(cfg, params=params, device="cpu", kv_layout=layout, kv_page_size=8)
    if layout == "paged":  # both packages route these families' paged decode to the reference
        assert teng.paged_attention_impl == "xla"
    jclient = JaxKLLMs(backend=TpuBackend(model=name, engine=jeng), model=name)
    client = KLLMs(backend=CudaBackend(config=BackendConfig(model=name, device="cpu"),
                                       engine=teng), model=name)
    try:
        want = jclient.chat.completions.parse(model=name, **REQUESTS[fmt], **SAMPLING)
        got = client.chat.completions.parse(model=name, **REQUESTS[fmt], **SAMPLING)
    finally:
        jclient.close()
        client.close()
    assert teng.last_launch_stats["kv_layout"] == layout
    assert len(got.choices) == len(want.choices) == SAMPLING["n"] + 1
    for g, w in zip(got.choices[1:], want.choices[1:]):
        assert [e.token for e in g.logprobs.content] == [e.token for e in w.logprobs.content]
        np.testing.assert_allclose([e.logprob for e in g.logprobs.content],
                                   [e.logprob for e in w.logprobs.content], atol=1e-5, rtol=0)
        assert g.finish_reason == w.finish_reason
        assert g.message.content == w.message.content
        assert g.message.parsed == w.message.parsed
    assert got.choices[0].message.content == want.choices[0].message.content
    assert got.choices[0].message.parsed == want.choices[0].message.parsed
    if fmt == "invoice":  # every sample finished: the consensus validates
        assert isinstance(got.choices[0].message.parsed, InvoiceStatus)
    assert (got.likelihoods is None) == (want.likelihoods is None)
    if want.likelihoods is not None:
        g, w = _flat(got.likelihoods), _flat(want.likelihoods)
        assert g.keys() == w.keys()
        np.testing.assert_allclose([g[k] for k in w], [w[k] for k in w], atol=1e-6, rtol=0)
    assert got.usage.model_dump() == want.usage.model_dump()


# The eight samples of the smoke's family parse request (the Record schema,
# 64 tokens) at half depth on one H100, seeded weights, as the card wrote
# them: Gemma-2-9B at 21 of its 42 layers (every sample legal under the
# grammar, six finished and valid, two cut at ``max_tokens``) and
# Mistral-7B at 16 of its 32 (legal, three finished and valid).
HALF_DEPTH_CARD_SAMPLES = {
    "gemma9b_21_layers": ([
        '{"name":"JF/,_\\rqU*\'90zF3>,{bJ9=,D;<D5i_zr","count":323}',
        '{"name":"S","count":-59359}',
        '{"name":">*i|_`.","count":232}',
        '{"name":"m\\u3D2FGC,Yi6K,zYDv;0E,0]z_^n.0{T-.r]#9r:9yKHzqcY\\nu]z3',
        '{"name":"\\rzi2 j\\r","count":-9013502232323299323932}',
        '{"name":"\\\\93-0]","count":33223232332232}',
        '{"name":"=m29Errr|3Mi]?Ps<rZ,\'],M0?P2i,yTsmi3|r&^J_z_;FzFWYP.ME0',
        '{"name":"Zz-kz]zze3R#3","count":330369032}',
    ], 6, -9.013502232323299e+21),
    "mistral7b_16_layers": ([
        '{"name":"","count":740993272743427283552435454234271433}',
        '{"name":"0","count":27176673477284132343194336433284642641494766',
        '{"name":">*C|[)5","count":2327333494}',
        '{"name":"mVuL[y mCgYs6K)b))6:Vv[7:%_))60{TgT`)[9):vyVvz|)YgT*]{3',
        '{"name":"g9Vb)TnU}:TsH)|)[))rD)y)gi)y)Fgb~v]zy)L|vC\'","count":-3',
        '{"name":"y;93{0LTVV)|]Tb)y_|wG3))))%)r)Hv)n9)|&bYVOgL{O_`T)))6P"',
        '{"name":"g~bUVL4y|;Ti1?7sT)Tb","count":2743434474118}',
        '{"name":"4~~));zwe3RK)4vemh|G)vTv))r6)yd))C))nV)D6`)T))y)y;`DRv|',
    ], 3, 7.409932727434273e+35),
}


@pytest.mark.parametrize("label", sorted(HALF_DEPTH_CARD_SAMPLES))
def test_half_depth_card_samples_consolidate_as_in_jax(label):
    """Those samples through both packages' ``parse()`` on the scripted
    backend: the same consensus, whose ``count`` is the numeric cluster's
    pick, a float beyond pydantic's integer range, so ``parsed`` is None in
    both packages; the finished originals parse."""
    from k_llms_tpu.backends.fake import FakeBackend as JaxFake
    from k_llms_tpu_torch.backends.fake import FakeBackend

    samples, n_finished, count = HALF_DEPTH_CARD_SAMPLES[label]
    out = {}
    for name, client_cls, fake in (("port", KLLMs, FakeBackend), ("jax", JaxKLLMs, JaxFake)):
        client = client_cls(backend=fake(responses=[samples]), model="m")
        out[name] = client.chat.completions.parse(messages=[{"role": "user", "content": "x"}],
                                                  model="m", n=8, response_format=Record)
    got, want = out["port"], out["jax"]
    assert got.choices[0].message.content == want.choices[0].message.content
    assert got.likelihoods == want.likelihoods
    assert got.choices[0].message.parsed is None and want.choices[0].message.parsed is None
    consensus = json.loads(got.choices[0].message.content)
    assert consensus["count"] == count
    parsed = [c.message.parsed for c in got.choices[1:]]
    assert parsed == [c.message.parsed for c in want.choices[1:]]
    assert sum(p is not None for p in parsed) == n_finished
    with pytest.raises(ValueError, match="int_parsing_size"):
        Record.model_validate(consensus)
