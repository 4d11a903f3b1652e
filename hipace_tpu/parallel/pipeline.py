"""Longitudinal pipeline parallelism over a jax.sharding.Mesh.

A JAX re-design of the reference's only distributed mechanism
(ref: /root/reference/src/utils/MultiBuffer.{H,cpp}; Hipace.cpp:400-401):
rank r computes time steps r, r+N, ... and streams pushed beam slices
head-to-tail to rank r+1 through a ring of MPI_Isend/Irecv buffers.

Here the ring is a mesh axis: device d runs time step d. The zeta sweep
becomes a *skewed tick loop* — at global tick t, device d processes slice
(nz-1) - (t - d); after each tick the just-pushed beam slice block is
ppermuted to device d+1, which bins the received particles into its own
per-slice receive buffer by their (new) zeta. Lockstep lax.scan replaces the
reference's async progress state machine; the fill/drain bubble is
(n_dev - 1) / (nz + n_dev - 1), negligible for the 1000s-of-slices decks the
reference targets. The ring wraps: device n-1 streams to device 0, whose
receive buffer after the final tick is the beam after n_dev time steps.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..particles import beam as bm
from ..pipeline.step import make_slice_step, init_field_state, empty_slip


_STREAM_KEYS = bm.BEAM_ATTRS + bm.BEAM_INT_ATTRS + ("valid",)


def _bin_block_into(buf: dict, counters: jnp.ndarray, block: dict, geom,
                    cap2: int):
    """Scatter a received particle block into the per-slice receive buffer.

    buf: dict of (nz, cap2) arrays; counters: (nz,) write cursors.
    The analogue of MultiBuffer's per-slice recv bookkeeping.
    """
    nz = geom.nz
    isl = bm.slice_index(block["z"], geom)
    ok = block["valid"] & (isl >= 0) & (isl < nz)
    isl_c = jnp.where(ok, isl, nz)
    # rank within this block per destination slice
    order = jnp.argsort(isl_c, stable=True)
    isl_s = isl_c[order]
    starts = jnp.searchsorted(isl_s, jnp.arange(nz + 1))
    rank = jnp.arange(isl_s.size) - starts[jnp.clip(isl_s, 0, nz)]
    base = counters[jnp.clip(isl_s, 0, nz - 1)]
    slot = base + rank
    keep = (isl_s < nz) & (slot < cap2)
    dst = jnp.where(keep, isl_s * cap2 + slot, nz * cap2)

    new_buf = {}
    for k in _STREAM_KEYS:
        src = block[k][order]
        if k == "valid":
            src = src & keep
        flat = buf[k].reshape(-1)
        flat = jnp.concatenate([flat, jnp.zeros((1,), flat.dtype)])
        flat = flat.at[dst].set(src)
        new_buf[k] = flat[:-1].reshape(nz, cap2)
    add = jnp.zeros((nz + 1,), counters.dtype).at[jnp.clip(isl_s, 0, nz)].add(
        keep.astype(counters.dtype))
    return new_buf, counters + add[:nz]


def make_pipelined_evolve(cfg, dtype, n_devices: int, beam_cap: int,
                          axis_name: str = "pipe", production: bool = False):
    """Build the shard_map'd multi-step evolve: device d runs step d.

    production=True additionally stages per-device diagnostics (the same
    `ys` rows the serial driver stacks: legacy "diag", per-diag "diagf_*",
    in-situ moments, counters) into (nz, ...) buffers carried through the
    tick scan, and accepts per-device (dt, time) ladders + a base step —
    the analogue of the reference's per-rank staging FAB
    (ref Hipace.cpp:691, Fields::Copy) and of physical time streaming
    through the MultiBuffer (ref MultiBuffer.cpp:618-644, Hipace.cpp:411).

    Laser streaming: the reference's MultiBuffer packs 4 laser components
    per slice next to the beam (ref MultiBuffer.H:110-122). Here device d
    consumes device d-1's per-slice (np1, n00) emission exactly two ticks
    after it is sent, so a 2-stage shift register carried through the scan
    replaces a full (nz, ...) receive buffer; only the ring wrap back to
    device 0 (the laser state after n_dev steps) is binned into full
    buffers.
    """
    g = cfg.geom
    nz = g.nz
    slip_cap = cfg.slip_cap
    cap2 = beam_cap + slip_cap
    slice_step = make_slice_step(cfg, dtype)
    ctype = jnp.complex64 if dtype == jnp.float32 else jnp.complex128

    def init_plasmas(key, c_t):
        from ..particles import plasma as pl
        states = []
        pads = cfg.plasma_pad or (0,) * len(cfg.plasmas)
        for i, pcfg in enumerate(cfg.plasmas):
            key, sub = jax.random.split(key)
            st = pl.init_plasma(pcfg, g, sub, dtype, c_t,
                                cfg.normalized_units,
                                ab5=cfg.plasma_pusher == "ab5")
            states.append(pl.pad_plasma(st, pads[i]))
        return states

    def device_evolve(binned0, dts, times, base_step, key, laser0):
        """Runs under shard_map; binned0: (1, nz, cap2) local shard.
        dts/times: (1,) local shards of the per-device dt/time ladders.
        laser0: (1, nz_or_1, NY, NX) complex (n00, nm1) initial stream —
        only device 0's shard is real (from_file restart); zeros otherwise."""
        d = jax.lax.axis_index(axis_name)
        is_dev0 = d == 0
        binned0 = {k: v[0] for k, v in binned0.items()}
        laser0 = jax.tree.map(lambda v: v[0], laser0)
        dt = dts[0]
        time_d = times[0]

        plasmas = init_plasmas(key, cfg.pc.c * time_d)
        fields = init_field_state(cfg, dtype)
        # neutralizing background; pre-sort + banded path exactly like the
        # serial driver (pipeline/simulation.py _time_step)
        from ..particles import plasma as pl
        from ..pipeline.step import _banded_opts, _row_sort, banded_stripe_h
        banded = _banded_opts(cfg)
        if banded is not None:
            stripe_h = banded_stripe_h(cfg)
            static_ion = not any(pcf.can_ionize for pcf in cfg.plasmas)
            plasmas = [_row_sort(p, g, stripe_h, static_ion)
                       for p in plasmas]
        rhom = fields["RhomJzIons"]["rhomjz"]
        for p, pcfg in zip(plasmas, cfg.plasmas):
            if pcfg.neutralize_background:
                tmp, _ = pl.deposit_plasma(
                    p, ["rhomjz"], {"rhomjz": rhom}, g, pcfg, cfg.pc,
                    cfg.depos_order_xy, cfg.normalized_units,
                    flip_charge=True, banded=banded)
                rhom = tmp["rhomjz"]
        fields = dict(fields, RhomJzIons={"rhomjz": rhom})
        # fine-level neutralizing background (same as the serial driver)
        if cfg.mr_levels:
            from ..fields.mr import in_level_bounds
            for i, lv in enumerate(cfg.mr_levels):
                fion = fields[f"mr{i + 1}"]["RhomJzIons"]["rhomjz"]
                for p, pcfg in zip(plasmas, cfg.plasmas):
                    if pcfg.neutralize_background:
                        tmp, _ = pl.deposit_plasma(
                            p, ["rhomjz"], {"rhomjz": fion}, lv.geom, pcfg,
                            cfg.pc, cfg.depos_order_xy, cfg.normalized_units,
                            flip_charge=True,
                            extra_mask=in_level_bounds(p["x"], p["y"],
                                                       lv.geom), geom0=g)
                        fion = tmp["rhomjz"]
                fields[f"mr{i + 1}"] = dict(fields[f"mr{i + 1}"],
                                            RhomJzIons={"rhomjz": fion})

        recv_buf = {k: jnp.zeros((nz, cap2), binned0[k].dtype)
                    for k in _STREAM_KEYS}
        counters = jnp.zeros((nz,), jnp.int32)

        from ..pipeline.step import zero_moments
        carry0 = {
            "fields": fields, "plasma": plasmas,
            "slip": empty_slip(slip_cap, dtype),
            "dt": dt, "time": time_d,
            "min_uz": jnp.asarray(jnp.inf, dtype),
            "beam_moments": zero_moments(dtype),
            "step": base_step + d,
            "recv": recv_buf, "counters": counters,
        }
        merge_keys = ["fields", "plasma", "slip", "min_uz", "beam_moments"]
        if cfg.ionization_pairs or cfg.collisions:
            # per-device RNG stream (the serial driver splits a fresh sub-key
            # per step; fold the device index in so streams are independent)
            carry0["key"] = jax.random.fold_in(key, d)
            merge_keys.append("key")
        if cfg.salame_active:
            # SALAME runs at step 0 only (ref Hipace.cpp:673-678), i.e. on
            # device 0; slice_step's step==0 gate handles the rest
            from ..pipeline.salame import empty_salame_state
            carry0["salame"] = empty_salame_state(g, dtype)
            merge_keys.append("salame")
        if cfg.use_laser:
            from ..fields.laser import laser_empty_state, initial_chi
            lg = cfg.laser_geom if cfg.laser_geom is not None else g
            carry0["laser"] = laser_empty_state(lg, dtype)
            carry0["chi_initial"] = initial_chi(
                cfg.laser, cfg.plasmas, lg, cfg.pc, cfg.pc.c * time_d, dtype)
            merge_keys.append("laser")
            zsl = jnp.zeros(lg.slice_shape, ctype)
            # 2-tick delay line of received (np1, n00) laser slices
            carry0["lsr1"] = {"np1": zsl, "n00": zsl}
            carry0["lsr2"] = {"np1": zsl, "n00": zsl}
            # ring-wrap accumulation: the laser stream after n_dev steps
            carry0["laser_out"] = {
                "n00": jnp.zeros((nz,) + lg.slice_shape, ctype),
                "nm1": jnp.zeros((nz,) + lg.slice_shape, ctype)}

        int_diags = [dg for dg in cfg.diags
                     if dg.diag_type == "xy_integrated"]
        if production:
            if int_diags:
                from ..pipeline.step import diag_slice_shape

                def _dgeom(dg):
                    if dg.base.startswith("level_") and dg.base != "level_0":
                        return cfg.mr_levels[int(dg.base[-1]) - 1].geom
                    return g

                carry0["diag_int"] = {
                    dg.name: jnp.zeros(
                        diag_slice_shape(dg, _dgeom(dg)),
                        jnp.complex64 if "laserEnvelope" in dg.comps
                        and dtype == jnp.float32
                        else jnp.complex128 if "laserEnvelope" in dg.comps
                        else dtype)
                    for dg in int_diags}
                merge_keys.append("diag_int")
            # per-slice ys shapes -> (nz, ...) staging buffers (the
            # analogue of the reference's staging FArrayBox, Hipace.cpp:691)
            probe_keys = ["fields", "plasma", "slip", "dt", "time",
                          "min_uz", "beam_moments", "step"]
            for opt in ("laser", "chi_initial", "key", "salame", "diag_int"):
                if opt in carry0:
                    probe_keys.append(opt)
            probe_carry = {k: carry0[k] for k in probe_keys}
            probe_row = {k: binned0[k][0] for k in _STREAM_KEYS}
            probe_xs = {"islice": jnp.asarray(0, jnp.int32),
                        "beam_this": probe_row, "beam_next": dict(probe_row)}
            if cfg.use_laser:
                probe_xs["laser_n00"] = zsl
                probe_xs["laser_nm1"] = zsl
            _, ys_shapes = jax.eval_shape(slice_step, probe_carry, probe_xs)
            stage_keys = [k for k in ys_shapes
                          if k not in ("beam_out", "laser_np1", "laser_n00")]
            carry0["diag_stage"] = {
                k: jnp.zeros((nz,) + ys_shapes[k].shape, ys_shapes[k].dtype)
                for k in stage_keys}

        # stage d lags stage d-1 by TWO slices: processing slice i needs
        # the upstream step's slice i-1 output (the reference's
        # get_data(islice-1), Hipace.cpp:639-642), which upstream emits one
        # tick after its slice-i block.
        n_ticks = nz + 2 * (n_devices - 1)

        def tick(carry, t):
            rel = t - 2 * d                      # local slice counter
            active = (rel >= 0) & (rel < nz)
            i_local = jnp.clip(nz - 1 - rel, 0, nz - 1)

            # input rows: device 0 reads the initial beam, others the stream
            def row(k):
                a = jax.lax.dynamic_index_in_dim(binned0[k], i_local, 0,
                                                 keepdims=False)
                b = jax.lax.dynamic_index_in_dim(carry["recv"][k], i_local, 0,
                                                 keepdims=False)
                return jnp.where(is_dev0, a, b)

            def row_next(k):
                i_next = jnp.maximum(i_local - 1, 0)
                a = jax.lax.dynamic_index_in_dim(binned0[k], i_next, 0,
                                                 keepdims=False)
                b = jax.lax.dynamic_index_in_dim(carry["recv"][k], i_next, 0,
                                                 keepdims=False)
                v = jnp.where(is_dev0, a, b)
                if k == "valid":
                    v = v & (i_local > 0)
                return v

            beam_this = {k: row(k) for k in _STREAM_KEYS}
            beam_this["valid"] = beam_this["valid"] & active
            beam_next = {k: row_next(k) for k in _STREAM_KEYS}
            beam_next["valid"] = beam_next["valid"] & active

            xs = {"islice": i_local, "beam_this": beam_this,
                  "beam_next": beam_next}
            sub_keys = ["fields", "plasma", "slip", "dt", "time", "min_uz",
                        "beam_moments", "step"]
            if cfg.use_laser:
                # device 0 reads the initial stream (from_file restart or
                # zeros with the analytic step-0 init); others, the 2-tick
                # delayed upstream emission
                il = jnp.minimum(i_local, laser0["n00"].shape[0] - 1)
                xs["laser_n00"] = jnp.where(
                    is_dev0,
                    jax.lax.dynamic_index_in_dim(laser0["n00"], il, 0,
                                                 keepdims=False),
                    carry["lsr2"]["np1"])
                xs["laser_nm1"] = jnp.where(
                    is_dev0,
                    jax.lax.dynamic_index_in_dim(laser0["nm1"], il, 0,
                                                 keepdims=False),
                    carry["lsr2"]["n00"])
                sub_keys += ["laser", "chi_initial"]
            if "key" in carry:
                sub_keys.append("key")
            if "salame" in carry:
                sub_keys.append("salame")
            if "diag_int" in carry:
                sub_keys.append("diag_int")
            sub_carry = {k: carry[k] for k in sub_keys}
            new_sub, ys = slice_step(sub_carry, xs)

            # inactive devices keep their state unchanged
            def sel(new, old):
                return jax.tree.map(
                    lambda a, b: jnp.where(active, a, b), new, old)
            merged = sel({k: new_sub[k] for k in merge_keys},
                         {k: carry[k] for k in merge_keys})

            if production:
                new_stage = {}
                for k, buf in carry["diag_stage"].items():
                    upd = jax.lax.dynamic_update_index_in_dim(
                        buf, ys[k].astype(buf.dtype), i_local, 0)
                    new_stage[k] = jnp.where(active, upd, buf)
                carry = dict(carry, diag_stage=new_stage)

            emit = dict(ys["beam_out"])
            emit["valid"] = emit["valid"] & active

            # stream to the next pipeline stage (ring)
            perm = [(i, (i + 1) % n_devices) for i in range(n_devices)]
            received = {k: jax.lax.ppermute(emit[k], axis_name, perm)
                        for k in _STREAM_KEYS}
            recv, counters = _bin_block_into(carry["recv"], carry["counters"],
                                             received, g, cap2)

            carry = dict(carry, recv=recv, counters=counters, **merged)
            if cfg.use_laser:
                lrecv = {
                    "np1": jax.lax.ppermute(ys["laser_np1"], axis_name, perm),
                    "n00": jax.lax.ppermute(ys["laser_n00"], axis_name, perm),
                }
                # the slice index the ring sender just processed; the sender
                # of device d is (d-1) mod n — for device 0 that wraps to
                # device n-1 (the final time step, whose stream is the
                # laser state this function returns)
                d_prev = (d - 1) % n_devices
                rel_prev = t - 2 * d_prev
                sender_active = (rel_prev >= 0) & (rel_prev < nz)
                i_prev = jnp.clip(nz - 1 - rel_prev, 0, nz - 1)
                lout = carry["laser_out"]
                upd_n00 = jax.lax.dynamic_update_index_in_dim(
                    lout["n00"], lrecv["np1"], i_prev, 0)
                upd_nm1 = jax.lax.dynamic_update_index_in_dim(
                    lout["nm1"], lrecv["n00"], i_prev, 0)
                lout = {
                    "n00": jnp.where(sender_active, upd_n00, lout["n00"]),
                    "nm1": jnp.where(sender_active, upd_nm1, lout["nm1"]),
                }
                carry = dict(carry, lsr2=carry["lsr1"], lsr1=lrecv,
                             laser_out=lout)
            return carry, None

        carry, _ = jax.lax.scan(tick, carry0, jnp.arange(n_ticks))

        # flush remaining slipped particles around the ring once
        perm = [(i, (i + 1) % n_devices) for i in range(n_devices)]
        slip_blk = {k: jax.lax.ppermute(carry["slip"][k], axis_name, perm)
                    for k in _STREAM_KEYS}
        recv, counters = _bin_block_into(carry["recv"], carry["counters"],
                                         slip_blk, g, cap2)

        out = {k: v[None] for k, v in recv.items()}
        if cfg.use_laser:
            laser_out = {k: v[None] for k, v in carry["laser_out"].items()}
        else:
            laser_out = {"n00": jnp.zeros((1, 1), ctype),
                         "nm1": jnp.zeros((1, 1), ctype)}
        if production:
            outs = {
                "beam": out,
                "min_uz": carry["min_uz"][None],
                "moments": {k: v[None]
                            for k, v in carry["beam_moments"].items()},
                "stage": {k: v[None]
                          for k, v in carry["diag_stage"].items()},
                "laser": laser_out,
            }
            if int_diags:
                outs["diag_int"] = {name: v[None] for name, v in
                                    carry["diag_int"].items()}
            return outs
        return out, carry["min_uz"][None], laser_out

    return device_evolve


def pipelined_evolve(cfg, dtype, binned, dt, key, devices=None,
                     axis_name: str = "pipe", laser_stream=None):
    """Run n_devices time steps, one per device, with slice streaming.

    binned: the (nz, cap) per-slice beam from bm.bin_beam. laser_stream:
    optional (n00, nm1) complex (nz, NY, NX) stacks (from_file restart).
    Returns (beam binned after n_devices steps, min_uz, laser_stream after
    n_devices steps or None).
    """
    devices = devices if devices is not None else jax.devices()
    n_dev = len(devices)
    mesh = Mesh(np.array(devices), (axis_name,))
    nz = cfg.geom.nz
    cap = binned["x"].shape[1]
    cap2 = cap + cfg.slip_cap
    ctype = jnp.complex64 if dtype == jnp.float32 else jnp.complex128

    # pad rows to cap2 and replicate-structure to (n_dev, nz, cap2):
    # only device 0's shard carries the real beam
    full = {}
    for k in _STREAM_KEYS:
        v = binned[k]
        pad = jnp.zeros((nz, cap2 - cap), v.dtype)
        row = jnp.concatenate([v, pad], axis=1)
        full[k] = jnp.concatenate(
            [row[None], jnp.zeros((n_dev - 1,) + row.shape, v.dtype)], axis=0) \
            if n_dev > 1 else row[None]

    # initial laser stream: only device 0's shard is real
    if cfg.use_laser and laser_stream is not None:
        l_nz = nz
        l0 = {"n00": laser_stream[0], "nm1": laser_stream[1]}
    else:
        l_nz = 1
        lgs = (cfg.laser_geom.slice_shape if cfg.use_laser
               and cfg.laser_geom is not None
               else cfg.geom.slice_shape if cfg.use_laser else (1, 1))
        z = jnp.zeros((1,) + lgs, ctype)
        l0 = {"n00": z, "nm1": z}
    laser0 = {k: jnp.concatenate(
        [v[None], jnp.zeros((n_dev - 1,) + v.shape, ctype)], axis=0)
        if n_dev > 1 else v[None] for k, v in l0.items()}

    dt_arr = jnp.full((n_dev,), dt, dtype)
    times = jnp.arange(n_dev, dtype=dtype) * jnp.asarray(dt, dtype)

    fn = make_pipelined_evolve(cfg, dtype, n_dev, cap, axis_name)
    shard = jax.shard_map(
        fn, mesh=mesh,
        in_specs=({k: P(axis_name) for k in _STREAM_KEYS}, P(axis_name),
                  P(axis_name), P(), P(),
                  {"n00": P(axis_name), "nm1": P(axis_name)}),
        out_specs=({k: P(axis_name) for k in _STREAM_KEYS}, P(axis_name),
                   {"n00": P(axis_name), "nm1": P(axis_name)}),
        check_vma=False)
    out, min_uz, laser_out = jax.jit(shard)(
        full, dt_arr, times, jnp.asarray(0, jnp.int32), key, laser0)
    final = {k: v[0] for k, v in out.items()}
    new_stream = ((laser_out["n00"][0], laser_out["nm1"][0])
                  if cfg.use_laser else None)
    return final, min_uz, new_stream


def pipelined_window(cfg, dtype, binned, dts, times, base_step, key,
                     devices=None, axis_name: str = "pipe",
                     laser_stream=None):
    """Production pipelined window: run len(devices) consecutive time steps
    (base_step + d on device d) with full diagnostics staging.

    dts/times: python sequences of length n_dev — the dt/time ladder for
    the window (host-predicted for adaptive dt, the analogue of
    ref AdaptiveTimeStep.cpp:338-370 + MultiBuffer time streaming).

    Returns a dict:
      beam:    {attr: (n_dev, nz, cap2)} — device d's buffer is the beam
               BEFORE step base_step+d for d>0; device 0's is the beam
               after the window's last step (the next window's input).
      stage:   {ys key: (n_dev, nz, ...)} per-device staged diagnostics,
               same keys/layout the serial driver's run_step returns.
      diag_int, min_uz (n_dev,), moments {k: (n_dev,)},
      laser: (n00, nm1) each (n_dev, nz, NY, NX) — device 0's row is the
             stream after the window.
    """
    devices = devices if devices is not None else jax.devices()
    n_dev = len(devices)
    mesh = Mesh(np.array(devices), (axis_name,))
    nz = cfg.geom.nz
    cap = binned["x"].shape[1]
    cap2 = cap + cfg.slip_cap
    ctype = jnp.complex64 if dtype == jnp.float32 else jnp.complex128

    full = {}
    for k in _STREAM_KEYS:
        v = binned[k]
        pad = jnp.zeros((nz, cap2 - cap), v.dtype)
        row = jnp.concatenate([v, pad], axis=1)
        full[k] = jnp.concatenate(
            [row[None], jnp.zeros((n_dev - 1,) + row.shape, v.dtype)],
            axis=0) if n_dev > 1 else row[None]

    if cfg.use_laser and laser_stream is not None:
        l0 = {"n00": laser_stream[0], "nm1": laser_stream[1]}
    else:
        lgs = (cfg.laser_geom.slice_shape if cfg.use_laser
               and cfg.laser_geom is not None
               else cfg.geom.slice_shape if cfg.use_laser else (1, 1))
        z = jnp.zeros((1,) + lgs, ctype)
        l0 = {"n00": z, "nm1": z}
    laser0 = {k: jnp.concatenate(
        [v[None], jnp.zeros((n_dev - 1,) + v.shape, ctype)], axis=0)
        if n_dev > 1 else v[None] for k, v in l0.items()}

    fn = make_pipelined_evolve(cfg, dtype, n_dev, cap, axis_name,
                               production=True)
    shard = jax.shard_map(
        fn, mesh=mesh,
        in_specs=({k: P(axis_name) for k in _STREAM_KEYS}, P(axis_name),
                  P(axis_name), P(), P(),
                  {"n00": P(axis_name), "nm1": P(axis_name)}),
        out_specs=P(axis_name), check_vma=False)
    return jax.jit(shard)(
        full, jnp.asarray(np.asarray(dts), dtype),
        jnp.asarray(np.asarray(times), dtype),
        jnp.asarray(base_step, jnp.int32), key, laser0)
