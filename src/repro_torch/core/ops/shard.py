"""Mesh-aware variants of the routed ops (twin of ``repro.core.ops.shard``).

Given a ``Route`` whose ``mesh`` names a non-trivial ``MeshSpec``, the
family dispatchers delegate here, and the routed impl runs on this
rank's block of the problem, with the schemes ``repro`` derives from the
impl's declared ``Partitioning`` and the same divisibility checks:

  * GEMM: column-parallel when n divides tp (each output column whole on
    one rank, so every rung is bit-equal to one device; also the
    ``gemm@logits`` vocab-TP path), else row-parallel on k with an f32
    all-reduce epilogue (partials accumulate in f32 and reduce in f32).
    m additionally shards over dp.
  * Attention: batch over dp, KV heads over tp, the impl unchanged.  When
    the batch cannot shard, the sequence shards over the data axis: q
    rows stay local, k/v are all-gathered, and the reference walk
    (``models.attention._flash_over_kv``) runs with the rank's global q
    offset in the mask.
  * Grouped MoE: expert-parallel.  Each rank takes its window of the
    global group offsets, bracketed by zero-weight sentinel groups, runs
    the impl on its ragged runs, and an f32 all-reduce over ``expert``
    reassembles the disjoint regions.  tp column-shards F.

``repro`` runs one program over global arrays (``shard_map``); the port
runs one process a rank (``torch.distributed``), explicit SPMD on plain
tensors.  A sharded op takes the tensors every rank of its groups holds
(replicated) and returns the whole result on each of them, so its callers
see the single-device function.  Its backward keeps that contract: a
replicated input's gradient is summed over the ranks that used a block of
it (``_Copy``), an assembled output's gradient is sliced back to the block
(``_Gather``), a reduced output's passes through (``_Reduce``).  DTensor's
own propagation is not used: a DTensor sharded on its last dim cannot go
through the models' in-place RMS norm (a placement change it refuses), so
each op places its blocks itself.  Every all-reduce is taken on an f32
tensor.

Inside ``local_batch()`` the data axis belongs to the caller: each data
rank holds its own batch rows (the train launcher's data parallelism,
``repro``'s batch in_shardings), so the dispatchers shard nothing over
``data`` there.

An identity mesh (``MeshSpec()`` / ``mesh=None``) short-circuits before
any of this: the single-device route traces the same graph.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time

import torch

__all__ = ["MeshSpec", "active_mesh", "unsharded_route", "abstract_meshes", "local_batch",
           "CollectiveSite", "STATS", "transport", "sharded_gemm_2d",
           "sharded_attention_forward", "sharded_attention_decode", "sharded_grouped_matmul"]


# ================================================================ MeshSpec

@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Hashable logical mesh description: parallel degrees per ROLE.

    Roles map onto mesh axis names: ``dp`` -> ``data`` (batch / FSDP),
    ``tp`` -> ``model`` (tensor parallel), ``ep`` -> ``expert`` (expert
    parallel), ``pod`` -> ``pod`` (pure DP across pods).  Plain ints only,
    so a MeshSpec rides inside ``Route`` / ``ExecutionPolicy``;
    ``build()`` resolves it to a ``DeviceMesh`` over the process group's
    ranks at dispatch time.
    """

    dp: int = 1
    tp: int = 1
    ep: int = 1
    pod: int = 1

    # (axis_name, role_field) in mesh-major order.
    AXES = (("pod", "pod"), ("data", "dp"), ("expert", "ep"), ("model", "tp"))

    def __post_init__(self) -> None:
        for _, role in self.AXES:
            v = getattr(self, role)
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"mesh degree {role}={v!r} must be a positive int")

    @property
    def size(self) -> int:
        return self.dp * self.tp * self.ep * self.pod

    @property
    def is_identity(self) -> bool:
        return self.size == 1

    def describe(self) -> str:
        """The canonical flag spelling, e.g. ``dp=2,tp=2,ep=2``."""
        parts = [f"dp={self.dp}", f"tp={self.tp}", f"ep={self.ep}"]
        if self.pod > 1:
            parts.append(f"pod={self.pod}")
        return ",".join(parts)

    @classmethod
    def parse(cls, text: str) -> MeshSpec:
        """Parse the ``--mesh`` grammar: ``dp=2,tp=2,ep=2`` (any subset of
        dp/tp/ep/pod, missing roles default to 1); ``none`` / ``1`` mean
        the identity mesh."""
        text = text.strip().lower()
        if text in ("", "none", "1", "identity"):
            return cls()
        roles = {role for _, role in cls.AXES}
        kw: dict[str, int] = {}
        for token in text.split(","):
            key, sep, val = token.partition("=")
            key = key.strip()
            if not sep or key not in roles:
                raise ValueError(
                    f"bad --mesh token {token!r}; grammar: "
                    f"dp=<int>,tp=<int>,ep=<int>[,pod=<int>] or 'none'")
            try:
                kw[key] = int(val)
            except ValueError:
                raise ValueError(f"bad --mesh degree {val!r} for {key!r}") from None
        return cls(**kw)

    @classmethod
    def from_shape(cls, shape: tuple[int, ...], axes: tuple[str, ...]) -> MeshSpec:
        """Lift a (shape, axis-names) description (``choose_mesh_shape``'s
        return) into a MeshSpec."""
        role_of = {axis: role for axis, role in cls.AXES}
        return cls(**{role_of[a]: s for a, s in zip(axes, shape) if a in role_of})

    def build(self):
        """The ``DeviceMesh`` over ranks ``0 .. size-1`` of the default
        process group (cached: every caller shares one object).  Axes are
        always ``(data, expert, model)``, with a leading ``pod`` when
        pod > 1; size-1 axes are kept.  Ranks past ``size`` get no
        coordinate and may not dispatch on it."""
        return _build_mesh(self)

    def axis_items(self) -> tuple[tuple[str, int], ...]:
        items = [("data", self.dp), ("expert", self.ep), ("model", self.tp)]
        if self.pod > 1:
            items.insert(0, ("pod", self.pod))
        return tuple(items)


@functools.lru_cache(maxsize=None)
def _build_mesh(spec: MeshSpec):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError(f"mesh {spec.describe()} needs an initialized process group "
                           f"(the launchers start one rank per mesh position)")
    world = dist.get_world_size()
    if world < spec.size:
        raise ValueError(f"mesh {spec.describe()} needs {spec.size} ranks; "
                         f"the process group has {world}")
    items = spec.axis_items()
    ranks = torch.arange(spec.size).reshape(tuple(s for _, s in items))
    return DeviceMesh(_DEVICE_TYPE, ranks, mesh_dim_names=tuple(a for a, _ in items))


_DEVICE_TYPE = "cpu"


def _on_cuda() -> bool:
    return _DEVICE_TYPE == "cuda"


def set_device_type(kind: str) -> None:
    """Where this rank's tensors live (``cuda`` or ``cpu``): the launchers
    set it before the first ``build()``."""
    global _DEVICE_TYPE
    _DEVICE_TYPE = kind
    _build_mesh.cache_clear()


def reset() -> None:
    """Forget the built meshes (before a process group is destroyed)."""
    _build_mesh.cache_clear()


def active_mesh(mesh: MeshSpec | None) -> MeshSpec | None:
    """None unless ``mesh`` actually distributes anything: the identity
    short-circuit every dispatcher checks first."""
    if mesh is None or mesh.is_identity:
        return None
    return mesh


def unsharded_route(route):
    """The route the impl runs on its block (no nested mesh dispatch); a
    route without a mesh comes back as it is."""
    return route if route.mesh is None else dataclasses.replace(route, mesh=None)


_LOCAL_BATCH = False


@contextlib.contextmanager
def local_batch(share: int = 1):
    """The caller holds this data rank's own batch rows, 1/``share`` of
    the batch: ops shard nothing over the data axis (see the module
    docstring), and every launch plans as the whole batch would."""
    global _LOCAL_BATCH
    prev, _LOCAL_BATCH = _LOCAL_BATCH, True
    try:
        with planned_whole(share):
            yield
    finally:
        _LOCAL_BATCH = prev


@contextlib.contextmanager
def planned_whole(share: int):
    """Launches inside plan their splits as the problem ``share`` times
    their block's grid would on one device (``kernels.gemm_tiled.
    SM_SHARE``): a block cut on whole tiles then sums K, or walks its KV
    cache, in the same splits as one device."""
    if share == 1 or _RECORD is not None:
        yield
        return
    from repro_torch.kernels import gemm_tiled
    prev = gemm_tiled.SM_SHARE
    gemm_tiled.SM_SHARE = prev * share
    try:
        yield
    finally:
        gemm_tiled.SM_SHARE = prev


# ============================================================ collectives

@dataclasses.dataclass(frozen=True)
class CollectiveSite:
    """One collective as a sharded op issues it: ``prim`` (``psum`` /
    ``all_gather``, ``repro``'s primitive names), the mesh axes, the
    operand dtype, and ``boundary``: the gather that assembles a sharded
    output for the caller, which ``repro``'s ``shard_map`` does at its
    out_specs rather than in the body."""

    prim: str
    axes: tuple[str, ...]
    dtype: torch.dtype
    boundary: bool = False


class _TraceMesh:
    """``build()``'s stand-in inside ``abstract_meshes()``: coordinate 0
    on every axis, no peers; collectives are recorded, not run."""

    def __init__(self, spec: MeshSpec):
        self.sizes = dict(spec.axis_items())

    def size(self, axis: str) -> int:
        return self.sizes[axis]

    def coord(self, axis: str) -> int:
        return 0


class _Mesh:
    """This rank's view of a built ``DeviceMesh``: axis sizes,
    coordinates and groups."""

    def __init__(self, spec: MeshSpec):
        self.spec = spec
        self.dm = spec.build()
        if self.dm.get_coordinate() is None:
            raise RuntimeError(f"rank outside mesh {spec.describe()} dispatched a sharded op")
        self.sizes = dict(spec.axis_items())

    def size(self, axis: str) -> int:
        return self.sizes[axis]

    def coord(self, axis: str) -> int:
        return self.dm.get_local_rank(axis)

    def group(self, axis: str):
        return self.dm.get_group(axis)


_RECORD: list[CollectiveSite] | None = None


@contextlib.contextmanager
def abstract_meshes():
    """Trace sharded dispatch with no peers (the static auditor's hook).

    Inside, every mesh resolves to coordinate 0 on each axis with no
    process group, and each collective a sharded op issues is recorded
    (the yielded list of ``CollectiveSite``) and stood in for by a local
    op of its output shape, so ``make_fx`` over a mesh-carrying route
    traces on any host.  Tracing only: the numbers are not a rank's."""
    global _RECORD
    prev, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = prev


def _mesh_for(spec: MeshSpec):
    return _TraceMesh(spec) if _RECORD is not None else _Mesh(spec)


# Every collective's count, host seconds and bytes in this process (the
# card phase reads the share of wall time spent in collectives).
STATS = {"calls": 0, "seconds": 0.0, "bytes": 0}


def transport() -> str:
    """The collective transport of the default process group, as the
    card phase reports it."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return "none"
    backend = dist.get_backend()
    if backend == "gloo" and _on_cuda():
        return "gloo (CUDA tensors staged through host memory by the backend)"
    return backend


def _timed(fn, t: torch.Tensor):
    t0 = time.perf_counter()
    out = fn()
    STATS["calls"] += 1
    STATS["seconds"] += time.perf_counter() - t0
    STATS["bytes"] += t.numel() * t.element_size()
    return out


def _psum(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum over the ranks of ``axis``."""
    if _RECORD is not None:
        _RECORD.append(CollectiveSite("psum", (axis,), t.dtype))
        return t.clone()
    return psum_(t.detach().contiguous().clone(), mesh, axis)


def psum_(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum over the ranks of ``axis`` in place (``t`` contiguous); the
    train launcher's gradient mean, which must not hold a second copy of
    the gradients."""
    import torch.distributed as dist
    _timed(lambda: dist.all_reduce(t, group=mesh.group(axis)), t)
    return t


def _all_gather(t: torch.Tensor, dim: int, mesh, axis: str, *,
                boundary: bool = False) -> torch.Tensor:
    """Concatenate the ranks' blocks of ``axis`` along ``dim``."""
    n = mesh.size(axis)
    if _RECORD is not None:
        _RECORD.append(CollectiveSite("all_gather", (axis,), t.dtype, boundary))
        return torch.cat([t] * n, dim)
    import torch.distributed as dist
    src = t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    _timed(lambda: dist.all_gather(parts, src, group=mesh.group(axis)), src)
    return torch.cat(parts, dim)


def _block(t: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` (a view)."""
    n = t.shape[dim] // mesh.size(axis)
    return t.narrow(dim, mesh.coord(axis) * n, n)


class _Copy(torch.autograd.Function):
    """A replicated input entering blocked compute: identity forward; the
    ranks' gradients of their blocks summed backward."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        for axis in ctx.axes:
            g = _psum(g.float(), ctx.mesh, axis).to(g.dtype)
        return g, None, None


class _Gather(torch.autograd.Function):
    """Assemble a sharded output (every rank then holds all of it): the
    backward takes the rank's block of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, dim, mesh, axis, boundary):
        ctx.dim, ctx.mesh, ctx.axis = dim, mesh, axis
        return _all_gather(x, dim, mesh, axis, boundary=boundary)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.dim, ctx.mesh, ctx.axis).contiguous(), None, None, None, None


class _GatherIn(torch.autograd.Function):
    """Gather blocks that each rank then uses for its own part of the
    work (the sequence-parallel KV): the backward sums the ranks'
    gradients and takes the rank's block."""

    @staticmethod
    def forward(ctx, x, dim, mesh, axis):
        ctx.dim, ctx.mesh, ctx.axis = dim, mesh, axis
        return _all_gather(x, dim, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        total = _psum(g.float(), ctx.mesh, ctx.axis).to(g.dtype)
        return _block(total, ctx.dim, ctx.mesh, ctx.axis).contiguous(), None, None, None


class _Reduce(torch.autograd.Function):
    """Sum of the ranks' partial results, reduced in f32: the backward
    hands each rank the (replicated) gradient unchanged."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _reduce_f32(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _reduce_f32(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The f32 reduce epilogue: partials accumulate in f32 and are summed
    in f32, so the ladder's bounds survive the split."""
    return _psum(x.float(), mesh, axis)


def _copy(x, mesh, axes):
    axes = tuple(a for a in axes if a)
    return _Copy.apply(x, mesh, axes) if axes else x


def _gather(x, dim, mesh, axis):
    return _Gather.apply(x, dim, mesh, axis, True) if axis else x


# ============================================================== TP/DP GEMM

def _dp_degree(spec: MeshSpec, roles, rows: int) -> int:
    if _LOCAL_BATCH or "dp" not in roles:
        return 1
    return spec.dp if rows % spec.dp == 0 else 1


def sharded_gemm_2d(impl, a: torch.Tensor, b: torch.Tensor, route) -> torch.Tensor:
    """One 2-D GEMM under the route's mesh (see the module docstring).
    Runs inside the routed einsum's ``autograd.Function``, whose backward
    contractions are sharded GEMMs of their own."""
    from repro_torch.core.ops.gemm import _impl_gemm_2d
    spec: MeshSpec = route.mesh
    roles = impl.capabilities.partitioning.roles
    m, k = a.shape
    n = b.shape[1]
    dp = _dp_degree(spec, roles, m)
    tp = spec.tp if "tp" in roles else 1
    col = tp > 1 and n % tp == 0
    row = tp > 1 and not col and k % tp == 0
    inner = unsharded_route(route)
    if dp == 1 and not col and not row:
        return _impl_gemm_2d(impl, a, b, inner)

    mesh = _mesh_for(spec)
    if dp > 1:
        a = _block(a, 0, mesh, "data")
    if col:
        b = _block(b, 1, mesh, "model")
    elif row:
        a = _block(a, 1, mesh, "model")
        b = _block(b, 0, mesh, "model")
    # a decode-size block (M <= 16) splits over its N tiles only
    with planned_whole((tp if col else 1) * (dp if m > 16 else 1)):
        out = _impl_gemm_2d(impl, a, b, inner)
    if row:
        out = _reduce_f32(out, mesh, "model")
    if col:
        out = _all_gather(out, 1, mesh, "model", boundary=True)
    if dp > 1:
        out = _all_gather(out, 0, mesh, "data", boundary=True)
    return out


# ============================================================== attention

def _offset_mask_fn(causal: bool, window: int | None, q_offset: int):
    """The reference mask closures with a GLOBAL q-row offset folded in
    (``models.attention`` builds the same masks with offset 0)."""
    if causal and window:
        return lambda qi, ki: (ki <= qi + q_offset) & (ki > qi + q_offset - window)
    if causal:
        return lambda qi, ki: ki <= qi + q_offset
    return lambda qi, ki: (ki >= 0) & (qi >= -1)


def sharded_attention_forward(impl, q, k, v, *, causal, window, softcap, route, kv_chunk):
    spec: MeshSpec = route.mesh
    roles = impl.capabilities.partitioning.roles
    b, sq, kvh, _, _ = q.shape
    skv = k.shape[1]
    dp = _dp_degree(spec, roles, b)
    tp = spec.tp if "tp" in roles and kvh % spec.tp == 0 else 1
    sp = 1
    if (not _LOCAL_BATCH and dp == 1 and spec.dp > 1 and "sp" in roles
            and sq % spec.dp == 0 and skv % spec.dp == 0 and (not causal or sq == skv)):
        sp = spec.dp
    inner = unsharded_route(route)
    if dp == 1 and tp == 1 and sp == 1:
        return impl.fn.forward(q, k, v, causal=causal, window=window, softcap=softcap,
                               route=inner, kv_chunk=kv_chunk)

    mesh = _mesh_for(spec)
    b_ax = "data" if dp > 1 else None
    h_ax = "model" if tp > 1 else None
    s_ax = "data" if sp > 1 else None
    q, k, v = (_copy(t, mesh, (b_ax or s_ax, h_ax)) for t in (q, k, v))
    if b_ax:
        q, k, v = (_block(t, 0, mesh, b_ax) for t in (q, k, v))
    if h_ax:
        q, k, v = (_block(t, 2, mesh, h_ax) for t in (q, k, v))
    if sp == 1:
        with planned_whole(dp * tp):
            out = impl.fn.forward(q, k, v, causal=causal, window=window, softcap=softcap,
                                  route=inner, kv_chunk=kv_chunk)
    else:
        # Sequence sharding: q rows stay local, KV is all-gathered and the
        # reference walk runs with the block's global q offset in the mask.
        # Chunking matches one device (same S, same kv_chunk), so every q
        # row sees identical arithmetic.
        from repro_torch.models.attention import _flash_over_kv
        off = mesh.coord("data") * (sq // sp)
        q = _block(q, 1, mesh, "data")
        k = _GatherIn.apply(_block(k, 1, mesh, "data").contiguous(), 1, mesh, "data")
        v = _GatherIn.apply(_block(v, 1, mesh, "data").contiguous(), 1, mesh, "data")
        out = _flash_over_kv(q, k, v, _offset_mask_fn(causal, window, off), inner, softcap,
                             kv_chunk=min(kv_chunk, skv))
    out = _gather(out, 2, mesh, h_ax)
    return _gather(out, 1 if s_ax else 0, mesh, b_ax or s_ax)


def sharded_attention_decode(impl, q, k_cache, v_cache, pos, *, window, softcap, route):
    spec: MeshSpec = route.mesh
    roles = impl.capabilities.partitioning.roles
    b, _, kvh, _, _ = q.shape
    dp = _dp_degree(spec, roles, b)
    tp = spec.tp if "tp" in roles and kvh % spec.tp == 0 else 1
    inner = unsharded_route(route)
    if dp == 1 and tp == 1:
        return impl.fn.decode(q, k_cache, v_cache, pos, window=window, softcap=softcap,
                              route=inner)
    mesh = _mesh_for(spec)
    b_ax = "data" if dp > 1 else None
    h_ax = "model" if tp > 1 else None
    if b_ax:
        q, k_cache, v_cache, pos = (_block(t, 0, mesh, b_ax)
                                    for t in (q, k_cache, v_cache, pos))
    if h_ax:
        q, k_cache, v_cache = (_block(t, 2, mesh, h_ax) for t in (q, k_cache, v_cache))
    with planned_whole(dp * tp):
        out = impl.fn.decode(q, k_cache, v_cache, pos, window=window, softcap=softcap,
                             route=inner)
    out = _gather(out, 2, mesh, h_ax)
    return _gather(out, 0, mesh, b_ax)


# ============================================================== grouped EP

def sharded_grouped_matmul(impl, x, w, group_offsets, route, *, bm: int,
                           group_counts=None) -> torch.Tensor:
    """The grouped GEMM under the route's mesh.  ``bm``, the alignment the
    dispatcher padded the runs to, comes from the global problem
    (``grouped_tiles`` at the global shape), so the ranks' smaller F
    cannot move it."""
    spec: MeshSpec = route.mesh
    roles = impl.capabilities.partitioning.roles
    e, _, f = w.shape
    ep = spec.ep if "ep" in roles and e % spec.ep == 0 else 1
    tp = spec.tp if "tp" in roles and f % spec.tp == 0 else 1
    inner = unsharded_route(route)
    if ep == 1 and tp == 1:
        return impl.fn(x, w, group_offsets, route=inner, bm=bm, group_counts=group_counts)

    mesh = _mesh_for(spec)
    e_ax = "expert" if ep > 1 else None
    f_ax = "model" if tp > 1 else None
    x = _copy(x, mesh, (e_ax, f_ax))
    w = _copy(w, mesh, (e_ax, f_ax))
    if f_ax:
        w = _block(w, 2, mesh, f_ax)
    if ep == 1:
        with planned_whole(tp):
            out = impl.fn(x, w, group_offsets, route=inner, bm=bm, group_counts=group_counts)
        return _gather(out, 1, mesh, f_ax)
    # This rank's window of the global offsets, bracketed by zero-weight
    # sentinel groups so the family contract holds locally (offsets[0] = 0,
    # offsets[-1] = N, all bm-aligned: the global offsets are, and so are
    # the window's ends).  Rows outside the window fall into the sentinels,
    # whose real-row count is 0, and come back exact zeros; the f32 sum over
    # the expert axis reassembles the disjoint regions exactly.
    e_loc = e // ep
    i = mesh.coord("expert")
    lo = group_offsets[i * e_loc:i * e_loc + e_loc + 1]
    offs = torch.cat([lo.new_zeros(1), lo, lo.new_full((1,), x.shape[0])])
    wb = _block(w, 0, mesh, "expert")
    wz = wb.new_zeros((1,) + tuple(wb.shape[1:]))
    counts = None
    if group_counts is not None:
        c = group_counts[i * e_loc:(i + 1) * e_loc]
        counts = torch.cat([c.new_zeros(1), c, c.new_zeros(1)])
    with planned_whole(tp):       # every rank walks the whole buffer; F is cut
        out = impl.fn(x, torch.cat([wz, wb, wz], dim=0), offs, route=inner, bm=bm,
                      group_counts=counts)
    out = _Reduce.apply(out, mesh, "expert")
    return _gather(out, 1, mesh, f_ax)
