"""Multi-process runs for the port's mesh tests, on the CPU under gloo.

``run_ranks(worker, world, tmp_path, *args)`` spawns ``world`` processes
that join one gloo process group through a ``FileStore`` under
``tmp_path``, runs ``worker(rank, world, *args)`` in each, and returns
what each returned (pickled through a file).  The run has a time limit of
its own: on expiry every child is killed and the test fails.  The workers
live here, not in the test modules, so a child imports torch and the port
only (never jax).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import pickle
import sys
import traceback

LIMIT_S = 150.0


def _child(rank, world, store_path, out_dir, worker, args):
    import torch.distributed as dist
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    import torch
    torch.set_num_threads(1)
    result = None
    try:
        store = dist.FileStore(store_path, world)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world)
        try:
            result = ("ok", worker(rank, world, *args))
        finally:
            dist.destroy_process_group()
    except BaseException:                      # reported to the parent
        result = ("error", traceback.format_exc())
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_ranks(worker, world: int, tmp_path, *args, limit_s: float = LIMIT_S):
    """``[worker(rank, world, *args) for each rank]``, each in its own
    process of one gloo group."""
    import multiprocessing as mp
    import time
    ctx = mp.get_context("spawn")
    out_dir = str(tmp_path / f"ranks-{world}-{time.monotonic_ns()}")
    os.makedirs(out_dir)
    store_path = os.path.join(out_dir, "store")
    procs = [ctx.Process(target=_child, args=(r, world, store_path, out_dir,
                                              worker, args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + limit_s
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    if alive:
        raise AssertionError(f"{len(alive)} of {world} ranks still running "
                             f"after {limit_s} s: killed")
    out = []
    for r in range(world):
        path = os.path.join(out_dir, f"rank{r}.pkl")
        if not os.path.exists(path):
            raise AssertionError(f"rank {r} exited with code "
                                 f"{procs[r].exitcode} and no result")
        with open(path, "rb") as f:
            status, value = pickle.load(f)
        if status != "ok":
            raise AssertionError(f"rank {r} failed:\n{value}")
        out.append(value)
    return out


# -- workers ------------------------------------------------------------------

def _src():
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(here), "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def compressed_psum_worker(rank, world, sets, codec):
    """The port's compressed_psum of ``xs[rank]`` over the whole group,
    for each ``xs`` of ``sets``."""
    _src()
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import compressed_psum
    return [compressed_psum(torch.from_numpy(xs[rank]), dist.group.WORLD,
                            codec).numpy() for xs in sets]


def flash_decode_worker(rank, world, q, k, v, kv_lens, data):
    """``_flash_decode_core`` on a cache sharded over a ``(data, model)``
    mesh: the sequence over ``model``, the batch over ``data``; returns
    the global offset of this rank's batch rows and its output rows at
    each of ``kv_lens``."""
    _src()
    import torch
    from repro_torch.distributed.sharding import distribute, shard_region
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.attention import _flash_decode_core
    mesh = make_host_mesh(world // data, device_type="cpu")
    spec = ("data", None, "model", None)
    kd, vd = (distribute({"t": torch.from_numpy(a)}, {"t": spec}, mesh)["t"]
              for a in (k, v))
    rows = shard_region(q.shape, ("data", None, None, None), mesh)[0]
    ql = torch.from_numpy(q)[rows]
    return rows.start, [_flash_decode_core(ql, kd, vd, scale=0.25,
                                           kv_len=n).numpy()
                        for n in kv_lens]


@contextlib.contextmanager
def with_capacity(train, capacity_factor):
    """A context in which ``train`` (``repro_torch.launch.train``) builds
    its configuration with the MoE capacity factor ``capacity_factor``
    (unchanged with ``None``)."""
    orig = train.get_any_config
    if capacity_factor is not None:
        def get_any_config(name):
            cfg = orig(name)
            return dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=capacity_factor))
        train.get_any_config = get_any_config
    try:
        yield
    finally:
        train.get_any_config = orig


@contextlib.contextmanager
def with_adam_eps(train, eps):
    """A context in which ``train`` (``repro_torch.launch.train``) builds
    its AdamW configuration with ``eps`` (unchanged with ``None``)."""
    orig = train.AdamWConfig
    if eps is not None:
        train.AdamWConfig = lambda **kw: orig(eps=eps, **kw)
    try:
        yield
    finally:
        train.AdamWConfig = orig


def train_worker(rank, world, argv, capacity_factor=None, adam_eps=None):
    """``launch.train.main(argv)`` on this rank (at the MoE capacity
    factor ``capacity_factor`` and the AdamW ``eps`` ``adam_eps`` where
    given); rank 0's losses and the final parameters gathered whole."""
    _src()
    from repro_torch.distributed.sharding import gather_full
    from repro_torch.launch import train
    from repro_torch.train.tree import leaves_with_paths
    with with_capacity(train, capacity_factor), \
            with_adam_eps(train, adam_eps):
        rec = train.main(argv)
    params = gather_full(rec["state"].params)
    if rank:
        return None
    return rec["losses"], {p: t.numpy() for p, t in leaves_with_paths(params)}


def serve_worker(rank, world, arch, seed, steps, prefill_caches=False):
    """Prefill and greedy decode steps of a reduced ``arch`` with DTensor
    parameters and caches on a ``(1, world)`` mesh (the caches' sequence
    over ``model``, ``flash_decode`` steps); returns the logits of every
    step and, with ``prefill_caches``, the caches after the prefill,
    gathered whole (``[group][position] -> {name: array}``)."""
    _src()
    import torch
    from repro_torch.configs import get_any_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.distributed.sharding import (cache_shardings,
                                                  distribute,
                                                  param_shardings)
    from repro_torch.launch.mesh import make_host_mesh, set_mesh
    from repro_torch.models import model as M
    from repro_torch.models.convert import to_reference, unstack
    cfg = get_any_config(arch).reduced()
    pcfg = ParallelConfig(compute_dtype="float32", kv_cache_dtype="float32",
                          remat="none")
    mesh = make_host_mesh(world, device_type="cpu")
    ref = to_reference(M.init_params(cfg, seed, device="cpu"))
    params = unstack(distribute(ref, param_shardings(cfg, pcfg, ref, mesh),
                                mesh))
    B, S = 2, 16
    caches = M.init_caches(cfg, pcfg, B, S + steps, device="cpu")
    caches = distribute(caches, cache_shardings(mesh, caches), mesh)
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    out = []
    with set_mesh(mesh):
        logits, caches = M.decode_step(cfg, pcfg, params, caches, toks, 0,
                                       attn_impl="blocked")
        after = prefill_caches and [
            [{k: c.full_tensor().clone().numpy() for k, c in d.items()}
             for d in group] for group in caches]
        out.append(logits[:, -1].numpy())
        nxt = logits[:, -1].argmax(-1)[:, None]
        for i in range(steps):
            logits, caches = M.decode_step(cfg, pcfg, params, caches, nxt,
                                           S + i, attn_impl="flash_decode")
            out.append(logits[:, -1].numpy())
            nxt = logits[:, -1].argmax(-1)[:, None]
    return (out, after) if prefill_caches else out


def block_worker(rank, world, arch, seed, batch, seq):
    """A Mamba-2 or mLSTM block of a reduced ``arch`` (float32,
    from ``seed``) on a ``(1, world)`` mesh: this rank's
    ``sharding.model_shard`` run through the block's own collectives,
    without a state and as a prefill of ``batch`` x ``seq`` from a zeroed
    state; returns both outputs and the state."""
    _src()
    import torch
    from repro_torch.configs import get_any_config
    from repro_torch.distributed.sharding import model_shard
    from repro_torch.launch.mesh import make_host_mesh, set_mesh
    from repro_torch.models import ssm, xlstm
    cfg = get_any_config(arch).reduced()
    gen = torch.Generator().manual_seed(seed)
    mamba = cfg.ssm is not None
    init, init_state, apply = (
        (ssm.init_mamba2, ssm.init_mamba2_state, ssm.apply_mamba2) if mamba
        else (xlstm.init_mlstm, xlstm.init_mlstm_state, xlstm.apply_mlstm))
    p = {k: v.detach() for k, v in init(cfg, gen, torch.float32,
                                        "cpu").items()}
    x = torch.randn((batch, seq, cfg.d_model), generator=gen)
    mesh = make_host_mesh(world, device_type="cpu")
    shard = model_shard(p, rank, world)
    state = init_state(cfg, batch, "cpu")
    with set_mesh(mesh), torch.no_grad():
        y, _ = apply(cfg, shard, x)
        y_state, _ = apply(cfg, shard, x, state=state)
    return (y.numpy(), y_state.numpy(),
            {k: v.numpy() for k, v in state.items()})


@contextlib.contextmanager
def recording_shards():
    """A context that records what each MoE, GQA, MLA, Mamba-2 and mLSTM
    block computed on: ``experts``, the expert stacks' leading dim (E_l)
    of every MoE call by dispatch; ``buffers``, the leading dim of every
    capacity dispatch's expert buffer; ``attn_weights``, the shapes of
    every GQA call's ``wq`` and ``wo`` as ``(wq, wo, tokens > 1)``;
    ``mla_heads``, ``ssm_heads`` and ``mlstm_heads``, the heads of every
    MLA, Mamba-2 and mLSTM call as ``(H, tokens > 1)``, an MLA call whose
    latent cache is a sequence shard (a DTensor) as ``(H, tokens > 1,
    the shard's positions, the cache's)``; ``mla_expanded``, every
    expansion of the latent to per-head keys and values as ``(H,
    positions)``, within a sequence shard's decode as ``(H, positions,
    the shard's first position, its positions, kv_len)``;
    ``redistributed``, the shape of every DTensor redistributed during a
    model step (``model.decode_step``) as ``(shape, the step's
    tokens)``."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models import attention, moe, ssm, xlstm
    from repro_torch.models import model as M
    seen = {"experts": set(), "buffers": set(), "attn_weights": set(),
            "mla_heads": set(), "ssm_heads": set(), "mlstm_heads": set(),
            "mla_expanded": set(), "redistributed": set()}
    apply_moe, ffn, apply_mla = (moe.apply_moe, moe._expert_ffn,
                                 attention.apply_mla)
    apply_attn = attention.apply_attn
    apply_mamba2, apply_mlstm = ssm.apply_mamba2, xlstm.apply_mlstm
    expand, shard_partials = (attention._mla_expand,
                              attention.mla_shard_partials)
    decode_step, redistribute = M.decode_step, DTensor.redistribute
    shard, step = [], []

    def rec_expand(cfg, p, latent, k_rope, H):
        seen["mla_expanded"].add((H, latent.shape[1], *shard))
        return expand(cfg, p, latent, k_rope, H)

    def rec_shard_partials(cfg, p, q, latent, k_rope, *, offset, kv_len):
        shard[:] = [offset, latent.shape[1], kv_len]
        try:
            return shard_partials(cfg, p, q, latent, k_rope, offset=offset,
                                  kv_len=kv_len)
        finally:
            shard.clear()

    def rec_decode_step(cfg, pcfg, params, caches, tokens, *args, **kw):
        step[:] = [tokens.shape[1]]
        try:
            return decode_step(cfg, pcfg, params, caches, tokens, *args,
                               **kw)
        finally:
            step.clear()

    def rec_redistribute(self, *args, **kw):
        if step:
            seen["redistributed"].add((tuple(self.shape), step[0]))
        return redistribute(self, *args, **kw)

    def rec_moe(cfg, p, x, **kw):
        kind = "dropless" if kw.get("dropless") else kw.get("dispatch",
                                                             "sorted")
        seen["experts"].add((kind, p["w_gate"].shape[0]))
        return apply_moe(cfg, p, x, **kw)

    def rec_ffn(p, xe):
        seen["buffers"].add(xe.shape[0])
        return ffn(p, xe)

    def rec_attn(cfg, p, x, positions, **kw):
        seen["attn_weights"].add((tuple(p["wq"].shape), tuple(p["wo"].shape),
                                  x.shape[1] > 1))
        return apply_attn(cfg, p, x, positions, **kw)

    def rec_mla(cfg, p, x, positions, **kw):
        qd = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
        entry = (p["wq"].shape[-1] // qd, x.shape[1] > 1)
        latent = (kw.get("cache") or {}).get("latent")
        if isinstance(latent, DTensor):
            entry += (latent.to_local().shape[1], latent.shape[1])
        seen["mla_heads"].add(entry)
        return apply_mla(cfg, p, x, positions, **kw)

    def rec_mamba2(cfg, p, x, **kw):
        seen["ssm_heads"].add((p["A_log"].shape[-1], x.shape[1] > 1))
        return apply_mamba2(cfg, p, x, **kw)

    def rec_mlstm(cfg, p, x, **kw):
        seen["mlstm_heads"].add((p["w_q"].shape[0], x.shape[1] > 1))
        return apply_mlstm(cfg, p, x, **kw)

    # the layers call them through their modules' attributes
    moe._expert_ffn, moe.apply_moe = rec_ffn, rec_moe
    attention.apply_mla, attention.apply_attn = rec_mla, rec_attn
    ssm.apply_mamba2, xlstm.apply_mlstm = rec_mamba2, rec_mlstm
    attention._mla_expand = rec_expand
    attention.mla_shard_partials = rec_shard_partials
    M.decode_step, DTensor.redistribute = rec_decode_step, rec_redistribute
    try:
        yield seen
    finally:
        moe._expert_ffn = ffn
        moe.apply_moe = apply_moe
        attention.apply_mla, attention.apply_attn = apply_mla, apply_attn
        ssm.apply_mamba2, xlstm.apply_mlstm = apply_mamba2, apply_mlstm
        attention._mla_expand = expand
        attention.mla_shard_partials = shard_partials
        M.decode_step, DTensor.redistribute = decode_step, redistribute


def expert_parallel_worker(rank, world, jobs, capacity_factor=None):
    """Each of ``jobs`` on this rank in turn: ``("train", argv[,
    adam_eps])`` (:func:`train_worker` at ``capacity_factor``), ``("serve", arch,
    seed, steps[, prefill_caches])`` (:func:`serve_worker`),
    ``("block", arch, seed, batch, seq)`` (:func:`block_worker`),
    ``("step", cases, trees, model)`` (:func:`mesh_step_worker`) or
    ``("chunks", arch, kv_heads, max_len, batch, model[, fill,
    prefill_impl])``
    (:func:`chunked_serve_worker`); returns, per job, its result and what
    its MoE, GQA, MLA, Mamba-2 and mLSTM blocks computed on
    (:func:`recording_shards`)."""
    workers = {"serve": serve_worker, "block": block_worker,
               "step": mesh_step_worker, "chunks": chunked_serve_worker}
    out = []
    for job in jobs:
        with recording_shards() as seen:
            if job[0] == "train":
                res = train_worker(rank, world, job[1], capacity_factor,
                                   *job[2:])
            else:
                res = workers[job[0]](rank, world, *job[1:])
        out.append((res, seen))
    return out


def mesh_step_worker(rank, world, cases, trees, model=1):
    """One training step of the port on a ``(world / model, model)`` mesh
    for each
    ``(arch, batch, seq, n_microbatches)`` of ``cases``: the arch's
    ``.reduced()`` configuration in float32 with ``remat="none"``, the
    parameters ``trees[arch]`` (the reference's tree as numpy) laid out
    by ``param_shardings``, ``make_batch(seed=1000)`` by
    ``batch_shardings``, the default ``AdamWConfig``; returns each step's
    ``loss_total``."""
    _src()
    from repro_torch.configs import get_any_config
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.data import make_batch
    from repro_torch.distributed import batch_shardings, param_shardings
    from repro_torch.distributed.sharding import distribute
    from repro_torch.launch.mesh import make_host_mesh, set_mesh
    from repro_torch.launch.steps import opt_shardings_like
    from repro_torch.models.convert import from_reference, to_reference
    from repro_torch.train import (AdamWConfig, TrainState, make_adamw,
                                   make_train_step)
    mesh = make_host_mesh(model, device_type="cpu")
    out = []
    for arch, batch, seq, n in cases:
        cfg = get_any_config(arch).reduced()
        pcfg = ParallelConfig(compute_dtype="float32", remat="none",
                              n_microbatches=n)
        ocfg = AdamWConfig()
        params = to_reference(from_reference(cfg, trees[arch], device="cpu"))
        state = TrainState(params, make_adamw(ocfg, pcfg)[0](params))
        pshard = param_shardings(cfg, pcfg, params, mesh)
        state = distribute(state, TrainState(
            params=pshard, opt=opt_shardings_like(pshard, mesh)), mesh)
        b = make_batch(cfg, batch, seq, seed=1000, device="cpu")
        b = distribute(b, batch_shardings(mesh, b), mesh)
        with set_mesh(mesh):
            _state, metrics = make_train_step(cfg, ocfg, pcfg)(state, b)
        out.append(float(metrics["loss_total"]))
    return out


def gather_rows_worker(rank, world, rows):
    """``distributed.sharding.gather_rows`` on a ``(pod, data, model) =
    (2, world / 2, 1)`` mesh: each data rank's ``rows`` rows filled with
    its data rank, gathered, then the gradient of the gathered rows
    against weights ``arange``; returns (data rank, gathered, gradient)."""
    _src()
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed.sharding import data_rank, gather_rows
    mesh = init_device_mesh("cpu", (2, world // 2, 1),
                            mesh_dim_names=("pod", "data", "model"))
    r = data_rank(mesh)
    x = torch.full((rows, 3), float(r), requires_grad=True)
    y = gather_rows(x, mesh)
    weights = torch.arange(y.numel(), dtype=torch.float32).reshape(y.shape)
    (y * weights).sum().backward()
    return r, y.detach().numpy(), x.grad.numpy()


# the chunked serving run: a prefill of PREFILL tokens (at cache index
# FILLED_START where the cache starts filled), a second chunk of CHUNK
# tokens after it, DECODES flash-decode steps
PREFILL, CHUNK, DECODES, FILLED_START = 8, 4, 4, 2


def chunked_config(arch, kv_heads=None):
    """``arch``'s ``.reduced()`` configuration, with ``n_kv_heads``
    replaced where ``kv_heads`` is given."""
    from repro_torch.configs import get_any_config
    cfg = get_any_config(arch).reduced()
    return cfg if kv_heads is None else dataclasses.replace(
        cfg, n_kv_heads=kv_heads)


def serve_chunks(cfg, batch, max_len, mesh=None, fill=False,
                 prefill_impl="blocked"):
    """A prefill of ``PREFILL`` tokens at cache index 0 (``FILLED_START``
    with ``fill``), a second chunk of ``CHUNK`` tokens and ``DECODES`` greedy flash-decode steps of
    ``cfg`` in float32 from seed 0, on ``mesh`` (parameters, caches and
    tokens laid out by the rules) or in one process.  ``fill``: every
    attention cache's head ``h`` starts filled with ``h + 1`` (``k``) and
    ``-(h + 1)`` (``v``): the positions before the prefill hold them.
    The prefill chunks run on the ``prefill_impl`` core, the decode
    steps on ``flash_decode`` over the tokens after the chunk (not
    greedy: each rank's logits are its own rows).  Returns this rank's first batch row, each step's last-position logits
    of its rows, and the caches gathered whole after each prefill chunk
    and after the last step (``[group][position] -> {name: array}``)."""
    import torch
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.distributed.sharding import (batch_shardings,
                                                  cache_shardings,
                                                  distribute,
                                                  param_shardings,
                                                  shard_region)
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.models import model as M
    from repro_torch.models.convert import to_reference, unstack
    pcfg = ParallelConfig(compute_dtype="float32", kv_cache_dtype="float32",
                          remat="none")
    params = to_reference(M.init_params(cfg, 0, device="cpu"))
    caches = M.init_caches(cfg, pcfg, batch, max_len, device="cpu")
    if fill:
        for group in caches:
            for c in group:
                if "k" in c:
                    heads = torch.arange(1, cfg.n_kv_heads + 1,
                                         dtype=torch.float32)
                    c["k"].copy_(heads[None, None, :, None, None]
                                 .expand_as(c["k"]))
                    c["v"].copy_(-c["k"])
    toks = torch.randint(0, cfg.vocab_size,
                         (batch, PREFILL + CHUNK + DECODES),
                         generator=torch.Generator().manual_seed(1))
    row0 = 0

    def lay(tokens):
        if mesh is None:
            return tokens
        return distribute({"t": tokens}, batch_shardings(
            mesh, {"t": tokens}), mesh)["t"]

    def whole(cs):
        return [[{k: (c.full_tensor() if mesh is not None else c)
                  .clone().numpy() for k, c in d.items()} for d in group]
                for group in cs]

    if mesh is not None:
        params = distribute(params, param_shardings(cfg, pcfg, params, mesh),
                            mesh)
        caches = distribute(caches, cache_shardings(mesh, caches), mesh)
        row0 = shard_region(tuple(toks.shape), batch_shardings(
            mesh, {"t": toks})["t"], mesh)[0].start
    params = unstack(params)
    logits, after = [], []
    start = FILLED_START if fill else 0
    with (set_mesh(mesh) if mesh is not None else contextlib.nullcontext()):
        for at, piece in ((start, toks[:, :PREFILL]),
                          (start + PREFILL, toks[:, PREFILL:PREFILL + CHUNK])):
            out, caches = M.decode_step(cfg, pcfg, params, caches,
                                        lay(piece), at,
                                        attn_impl=prefill_impl,
                                        last_only=True)
            logits.append(out[:, -1].numpy())
            after.append(whole(caches))
        at = start + PREFILL + CHUNK
        for i in range(DECODES):
            out, caches = M.decode_step(
                cfg, pcfg, params, caches,
                lay(toks[:, PREFILL + CHUNK + i:][:, :1]), at + i,
                attn_impl="flash_decode", last_only=True)
            logits.append(out[:, -1].numpy())
        after.append(whole(caches))
    return row0, logits, after


def chunked_serve_worker(rank, world, arch, kv_heads, max_len, batch, model,
                         fill=False, prefill_impl="blocked"):
    """:func:`serve_chunks` of ``chunked_config(arch, kv_heads)`` on a
    ``(world / model, model)`` mesh."""
    _src()
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(model, device_type="cpu")
    return serve_chunks(chunked_config(arch, kv_heads), batch, max_len,
                        mesh, fill, prefill_impl)
