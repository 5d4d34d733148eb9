"""The port's ring attention (kernels 14 and 15, ``parallel/ring_attention``)
against the JAX package's, on the CPU.

The ring-step kernels' plain versions, which CPU tensors run and the card
holds the CUDA kernels to, against JAX's ``ring_step_fwd`` /
``ring_step_bwd`` in interpret mode, with a partial shard and an entirely
masked one; the one-rank ring (``group=None``) against JAX's ``_ring_mha``
at one shard; then a ring of two ranks: two processes that import only the
port join a Gloo group on the CPU and run ``ring_mha_split`` (forward and
gradients), ``ring_attention`` and ``ring_vit_block`` (both tiers), held
against JAX's two-shard ring on the virtual mesh, as
``tests/test_ring_attention.py`` runs it, and count the kv sends.

Tolerances: f32 those of ``tests/test_ring_attention.py`` (2e-5 forward,
5e-5 gradients); bf16 one bf16 ulp of each tensor's largest element, where
a sum in another order moves a rounded p across a rounding boundary.
"""

import functools
import importlib
import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from devt_tpu.ops.fused_block import reference_vit_block
from devt_tpu.parallel import ring_attention as jra
from devt_tpu_torch.ops import flash_attention as tfa
from devt_tpu_torch.parallel import ring_attention as tra

# six test workers share the host's cores, and torch's default of one
# intra-op thread a core oversubscribes them: two threads a worker
torch.set_num_threads(2)

# ``devt_tpu.ops.flash_attention`` the attribute is a function of that name
jfa = importlib.import_module("devt_tpu.ops.flash_attention")
ROOT = pathlib.Path(__file__).resolve().parents[1]
FWD_TOL = dict(atol=2e-5, rtol=1e-5)
GRAD_TOL = dict(atol=5e-5, rtol=1e-4)
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(kind, got, want, tol=FWD_TOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, dtype=np.float32)
    if kind == "f32":
        np.testing.assert_allclose(got, want, **tol)
    else:
        assert np.abs(got - want).max() <= 2.0 ** -8 * np.abs(want).max()


B, S, HEADS, D = 2, 48, 2, 16
# the shard held now: every column live, the first 30 live (a partial
# shard), none live (a shard wholly past kv_len)
MASKS = {"full": S, "partial": 30, "masked": 0}


def _mask(live):
    return np.where(np.arange(S) < live, 0.0, jfa.NEG_INF).astype(
        np.float32)[None]


def _ring_inputs(kind):
    q, kv = _rand((B, S, HEADS * D), 0), _rand((B, S, 2 * HEADS * D), 1)
    return q, kv, tuple(torch.tensor(t).to(TORCH[kind]) for t in (q, kv))


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("which", list(MASKS))
def test_ring_step_fwd_plain_matches_jax_kernel(kind, which):
    """Kernel 14's plain version: o in q's dtype and the compact lse
    (``_lse_heads`` of JAX's 128-lane layout); the masked shard's o is
    finite and its lse -1e30 + log S, as JAX's."""
    q, kv, (tq, tkv) = _ring_inputs(kind)
    mask = _mask(MASKS[which])
    jo, jlse = jfa.ring_step_fwd(jnp.asarray(q, JNP[kind]),
                                 jnp.asarray(kv, JNP[kind]),
                                 jnp.asarray(mask), heads=HEADS,
                                 scale=D ** -0.5, interpret=True)
    o, lse = tfa.ring_step_fwd(tq, tkv, torch.tensor(mask), heads=HEADS,
                               scale=D ** -0.5)
    assert o.dtype == TORCH[kind] and lse.shape == (B, S, HEADS)
    assert torch.isfinite(o.float()).all()
    _close(kind, o, jo)
    jl = tra._lse_heads(torch.tensor(np.asarray(jlse)), HEADS)
    torch.testing.assert_close(lse, jl, atol=2e-5, rtol=1e-5)
    if which == "masked":
        assert torch.all(lse == np.float32(-1e30) + np.float32(np.log(S)))


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("which", list(MASKS))
def test_ring_step_bwd_plain_matches_jax_kernel(kind, which):
    """Kernel 15's plain version against the global lse (here the full
    shard's): f32 partials dq and dkv; a masked shard's are exact zeros."""
    q, kv, (tq, tkv) = _ring_inputs(kind)
    full = torch.tensor(_mask(S))
    o, lse = tfa.ring_step_fwd_plain(tq, tkv, full, HEADS, D ** -0.5)
    do = _rand((B, S, HEADS * D), 2)
    tdo = torch.tensor(do).to(TORCH[kind])
    mask = _mask(MASKS[which])
    lanes = np.repeat(lse.numpy()[..., None], 128, -1).reshape(B, S, -1)
    jdq, jdkv = jfa.ring_step_bwd(
        jnp.asarray(q, JNP[kind]), jnp.asarray(kv, JNP[kind]),
        jnp.asarray(mask), jnp.asarray(o.float().numpy(), JNP[kind]),
        jnp.asarray(lanes), jnp.asarray(do, JNP[kind]), heads=HEADS,
        scale=D ** -0.5, interpret=True)
    dq, dkv = tfa.ring_step_bwd(tq, tkv, torch.tensor(mask), o, lse, tdo,
                                heads=HEADS, scale=D ** -0.5)
    assert dq.dtype == dkv.dtype == torch.float32
    _close(kind, dq, jdq, GRAD_TOL)
    _close(kind, dkv, jdkv, GRAD_TOL)
    if which == "masked":
        assert not dq.any() and not dkv.any()


def test_colmask_and_combine_match_jax():
    """``_colmask`` (a partial chunk, one past kv_len) and ``_combine``
    (with the first hop's -1e30 accumulator and a masked hop)."""
    for blk in range(3):
        np.testing.assert_array_equal(
            tra._colmask(blk, 40, 48, 70, "cpu").numpy(),
            np.asarray(jra._colmask(jnp.int32(blk), 40, 48, 70)))
    o, oi = _rand((B, S, HEADS * D), 3), _rand((B, S, HEADS * D), 4)
    lse = np.full((B, S, HEADS), jfa.NEG_INF, np.float32)
    for lse_i in (_rand((B, S, HEADS), 5),
                  np.full((B, S, HEADS), -1e30 + np.log(S), np.float32)):
        jo, jl = jra._combine(jnp.asarray(o), jnp.asarray(lse),
                              jnp.asarray(oi), jnp.asarray(lse_i), HEADS)
        to, tl = tra._combine(*map(torch.tensor, (o, lse, oi, lse_i)),
                              HEADS)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **FWD_TOL)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FWD_TOL)
        o, lse = np.asarray(jo), np.asarray(jl)


@pytest.mark.parametrize("s_chunk,kv_len", [(40, 35), (48, 48)])
def test_one_rank_ring_matches_jax(s_chunk, kv_len):
    """``ring_mha_split`` with ``group=None`` (kernels 14 and 15's plain
    versions, one hop, no send) against JAX's ``_ring_mha`` at one shard:
    output and the gradients of q and kv; 40 rows pad to 48."""
    q = _rand((B, s_chunk, HEADS * D), 6, 0.5)
    kv = _rand((B, s_chunk, 2 * HEADS * D), 7, 0.5)
    w = _rand((B, s_chunk, HEADS * D), 8)

    def jloss(q, kv):
        o = jra.ring_mha_split(q, kv, heads=HEADS, kv_len=kv_len,
                               n_shards=1, interpret=True)
        return jnp.sum(o * w), o

    (_, jo), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True))(
        jnp.asarray(q), jnp.asarray(kv))
    tq, tkv = (torch.tensor(t, requires_grad=True) for t in (q, kv))
    sends = tra.ring_mha_split.kv_sends, tra.ring_mha_split.dkv_sends
    o = tra.ring_mha_split(tq, tkv, heads=HEADS, kv_len=kv_len)
    (o * torch.tensor(w)).sum().backward()
    assert (tra.ring_mha_split.kv_sends,
            tra.ring_mha_split.dkv_sends) == sends
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), **FWD_TOL)
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(jg[0]),
                               **GRAD_TOL)
    np.testing.assert_allclose(tkv.grad.numpy(), np.asarray(jg[1]),
                               **GRAD_TOL)


def _block_params(dim, mlp, seed):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=0.1):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {"g1": 1.0 + t(1, dim, scale=0.02), "b1": t(1, dim, scale=0.02),
            "wqkv": t(dim, 3 * dim), "wo": t(dim, dim), "bo": t(1, dim),
            "g2": 1.0 + t(1, dim, scale=0.02), "b2": t(1, dim, scale=0.02),
            "w1": t(dim, mlp), "bb1": t(1, mlp), "w2": t(mlp, dim),
            "bb2": t(1, dim)}


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("sp",))


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_one_rank_ring_vit_block_matches_jax(impl):
    """``ring_vit_block`` with ``group=None``: the f32 tier, and the kernel
    tier, which at one rank is ``ring_mha`` → ``fused_mha`` (kernel 3's
    plain version), against JAX's on a one-device mesh; both within the
    JAX package's bound of the f32 reference block."""
    dim, heads, kv_len = 64, 2, 29
    params = _block_params(dim, 128, 9)
    x = _rand((2, 32, dim), 10, 0.5)
    want = jax.jit(lambda x, p: jra.ring_vit_block(
        x, p, _mesh(1), heads=heads, kv_len=kv_len, axis="sp",
        interpret=True, impl=impl))(jnp.asarray(x), params)
    got = tra.ring_vit_block(torch.tensor(x), {k: torch.tensor(v) for k, v in
                                               params.items()},
                             heads=heads, kv_len=kv_len, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    ref = reference_vit_block(jnp.asarray(x), params, heads,
                              (dim // heads) ** -0.5, kv_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-5,
                               rtol=5e-5)


def test_sp_scope_is_bounded_and_reentrant():
    assert tra.active_sp_mesh() is None
    with tra.sp_scope("outer"):
        with tra.sp_scope("inner"):
            assert tra.active_sp_mesh() == "inner"
        assert tra.active_sp_mesh() == "outer"
    assert tra.active_sp_mesh() is None


# ---------------------------------------------------------------------------
# a ring of two ranks: Gloo on the CPU
# ---------------------------------------------------------------------------

# ring_mha_split: 80 tokens in chunks of 40 (padded to 48), kv_len 35 —
# rank 0's chunk partial, rank 1's wholly past kv_len
MHA_S, MHA_KV = 80, 35
# ring_attention: (1, 2, 64, 16), kv_len 50; ring_vit_block: the JAX
# test's (2, 32, 64), 2 heads, MLP 128, kv_len 29
ATT_S, ATT_KV, BLK_KV = 64, 50, 29

WORKER = r"""
import sys

import numpy as np
import torch
import torch.distributed as dist

from devt_tpu_torch.parallel import ring_attention as ra

rank, port, src, dst = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
heads, mha_kv, att_kv, blk_kv = (int(a) for a in sys.argv[5:9])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=2)
group = dist.group.WORLD
a = dict(np.load(src))
out = {}

c = a["q"].shape[1] // 2
mine = slice(rank * c, (rank + 1) * c)
q = torch.tensor(a["q"][:, mine], requires_grad=True)
kv = torch.tensor(a["kv"][:, mine], requires_grad=True)
o = ra.ring_mha_split(q, kv, heads=heads, kv_len=mha_kv, group=group)
out["sends_fwd"] = np.array([ra.ring_mha_split.kv_sends,
                             ra.ring_mha_split.dkv_sends])
(o * torch.tensor(a["w"][:, mine])).sum().backward()
out["sends"] = np.array([ra.ring_mha_split.kv_sends,
                         ra.ring_mha_split.dkv_sends])
out["o"], out["dq"], out["dkv"] = (t.detach().numpy()
                                   for t in (o, q.grad, kv.grad))

out["att"] = ra.ring_attention(
    *(torch.tensor(a[n]) for n in ("aq", "ak", "av")), group,
    kv_len=att_kv).numpy()
params = {k[2:]: torch.tensor(v) for k, v in a.items() if k.startswith("p_")}
for impl in ("jnp", "pallas"):
    out["block_" + impl] = ra.ring_vit_block(
        torch.tensor(a["x"]), params, group, heads=heads, kv_len=blk_kv,
        impl=impl).numpy()
np.savez(dst, **out)
dist.barrier()  # neither rank leaves while the other still talks to it
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' results (started first, so that they run while JAX
    compiles its side) and JAX's two-shard ring on the same arrays."""
    tmp = tmp_path_factory.mktemp("ring")
    a = {"q": _rand((B, MHA_S, HEADS * D), 11, 0.5),
         "kv": _rand((B, MHA_S, 2 * HEADS * D), 12, 0.5),
         "w": _rand((B, MHA_S, HEADS * D), 13),
         "aq": _rand((1, 2, ATT_S, D), 14), "ak": _rand((1, 2, ATT_S, D), 15),
         "av": _rand((1, 2, ATT_S, D), 16), "x": _rand((2, 32, 64), 17, 0.5)}
    params = _block_params(64, 128, 18)
    np.savez(tmp / "in.npz", **a, **{"p_" + k: v for k, v in params.items()})
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), port, str(tmp / "in.npz"),
         str(tmp / f"out{r}.npz"), str(HEADS), str(MHA_KV), str(ATT_KV),
         str(BLK_KV)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]

    mesh = _mesh(2)
    seq = P(None, "sp", None)
    mha = jax.shard_map(functools.partial(
        jra.ring_mha_split, heads=HEADS, kv_len=MHA_KV, axis_name="sp",
        n_shards=2, interpret=True), mesh=mesh, in_specs=(seq, seq),
        out_specs=seq, check_vma=False)

    def jloss(q, kv):
        o = mha(q, kv)
        return jnp.sum(o * a["w"]), o

    (_, jo), (jdq, jdkv) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(a["q"]),
                                              jnp.asarray(a["kv"]))
    want = {"o": jo, "dq": jdq, "dkv": jdkv,
            "att": jra.ring_attention(*(jnp.asarray(a[n]) for n in
                                        ("aq", "ak", "av")), mesh, axis="sp",
                                      kv_len=ATT_KV)}
    for impl in ("jnp", "pallas"):
        want["block_" + impl] = jax.jit(lambda x, p, impl=impl: jra.
                                        ring_vit_block(
            x, p, mesh, heads=HEADS, kv_len=BLK_KV, axis="sp",
            interpret=True, impl=impl))(jnp.asarray(a["x"]), params)

    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=120)[0])
        finally:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log}"
    ranks = [dict(np.load(tmp / f"out{r}.npz")) for r in range(2)]
    return ranks, {k: np.asarray(v) for k, v in want.items()}


def test_two_rank_ring_mha_split_matches_jax(two_ranks):
    """Forward and the gradients of q and kv: each rank's chunk against
    JAX's two-shard ring (rank 1's kv chunk wholly past kv_len)."""
    ranks, want = two_ranks
    for name, tol in (("o", FWD_TOL), ("dq", GRAD_TOL), ("dkv", GRAD_TOL)):
        got = np.concatenate([r[name] for r in ranks], axis=1)
        np.testing.assert_allclose(got, want[name], err_msg=name, **tol)


def test_two_rank_ring_sends_kv_n_minus_1_times_a_pass(two_ranks):
    """The kv chunk makes n - 1 = 1 send in the forward and 1 in the
    backward; the dkv accumulator n = 2 (the last one home)."""
    ranks, _ = two_ranks
    for r in ranks:
        assert r["sends_fwd"].tolist() == [1, 0]
        assert r["sends"].tolist() == [2, 2]


def test_two_rank_ring_attention_matches_jax(two_ranks):
    """The f32 tier on global inputs, gathered: the same on both ranks."""
    ranks, want = two_ranks
    for r in ranks:
        np.testing.assert_allclose(r["att"], want["att"], **FWD_TOL)


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_two_rank_ring_vit_block_matches_jax(two_ranks, impl):
    """The whole sequence-parallel block, both tiers (the kernel tier runs
    kernels 14 and 15's plain versions), gathered on both ranks."""
    ranks, want = two_ranks
    for r in ranks:
        np.testing.assert_allclose(r["block_" + impl], want["block_" + impl],
                                   **FWD_TOL)
