"""Dataset-generation task: parameter draws, the fused string kernel,
NaN/silence skip and the archival artifacts.

PyTorch port of ``torch_fdtd_string_tpu/tasks/simulate.py`` (reference
``src/task/simulate.py``).  Per batch: numpy parameter draws
(``core/params.py``), the first two state rows (``ops/fdm.py``), one call of
the fused string kernel over all steps (``ops/string_kernel.py``), then the
reference's artifact contract on disk per written item:
``output{,-u,-z}.wav``, ``simulation.npz`` (with the full ``state_u`` /
``state_z`` fields and the ``v_r``/``F_H``/``u_H`` probe traces),
``{string,bow,hammer}_params.npz`` and ``simulation_config.yaml``; per run
``skip_stats.json`` and the timing log ``gpu_time.txt`` (CUDA) or
``cpu_time.txt`` (CPU).  Plucked, bowed and hammered strings, and batches
that mix them per string (``model.excitation=null``), all run through it.

The device is chosen explicitly: the CPU, where the kernel's plain PyTorch
version runs, for ``proc.cpu=true`` or ``task.precision=double``; CUDA
otherwise, and a host without a usable card raises.  Not ported yet, and
refused with ``NotImplementedError``: MMS forcing, preset loading, fused
preprocessing, the NaN rescue ladder, plots and writing during the process
(see ROADMAP.md).
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import time

import numpy as np
import torch

from ..core import params as prm
from ..core.engine import SimConsts, StringParams
from ..ops import fdm
from ..ops.string_kernel import string_chunked
from ..utils import audio
from ..utils import misc as ms
from ..utils import wav as wavio


def select_device(cpu=False, precision="single"):
    """The CPU for ``proc.cpu=true`` or double precision, else CUDA; raises
    when CUDA is asked for and the host has no usable card."""
    if cpu or precision == "double":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a single-precision run needs a CUDA card and torch finds none; "
            "pass proc.cpu=true (or task.precision=double) to run on the CPU")
    return torch.device("cuda")


def _not_ported(what, item):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md {item})")


def kernel_inputs(state, consts: SimConsts, Nt, device, bow=None, hammer=None,
                  bow_mask=None, hammer_mask=None):
    """Positional tensors and keyword arguments of the batch's
    :func:`string_chunked` call: steps 2..Nt-1, run dtype, on ``device``.
    The ``bow`` / ``hammer`` dicts are built as the JAX package builds them
    (its ``_process_pallas``) when ``consts`` has that excitation."""
    dtype = torch.float64 if state.u0.dtype == np.float64 else torch.float32

    def to(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype, device=device)

    sp = StringParams(
        kappa=to(state.kappa), alpha=to(state.alpha), p_a=to(state.p_a),
        f0=to(state.f0[:, 2:Nt]), pos=to(state.pos), T60=to(state.T60),
    )
    u1, u2 = fdm.initialize_state_rows(state.u0, state.v0, consts.k)
    B = state.u0.shape[0]
    zl = lambda: torch.zeros((B, consts.M_l), dtype=dtype, device=device)
    args = (sp.f0, sp.kappa, sp.alpha, sp.pos, sp.T60, to(u1), to(u2), zl(), zl())
    kwargs = dict(
        k=consts.k, theta_t=consts.theta_t, lambda_c=consts.lambda_c,
        M_t=consts.M_t, M_l=consts.M_l,
        # sweep cap: the kernel's 24 reaches f32's tolerance; f64's is 2**29
        # times tighter, and after a bow's stick-slip switch has halved the
        # relaxation (~0.46 per sweep) it takes ~35 sweeps to reach it
        coupling_iters=24 if dtype == torch.float32 else 64,
        surface_integral=consts.surface_integral,
        collect_state=consts.collect_state,
        relative_error=consts.relative_error,
        manufactured=consts.manufactured, mms_centered=consts.mms_centered,
        # poison-only first pass: untrusted coupling exits become NaN
        gmres_rescue=False,
    )
    if consts.has_bow or consts.has_hammer:
        # the initial hammer displacements: uH1 the newer row (step 1)
        uH = dict(uH1=to(hammer.u_H[:, 1]), uH2=to(hammer.u_H[:, 0]))
        mask = lambda m: torch.as_tensor(np.asarray(m, bool), device=device)
    if consts.has_bow:
        kwargs["bow"] = dict(
            x_b=to(bow.x_b[:, 2:Nt]), v_b=to(bow.v_b[:, 2:Nt]),
            F_b=to(bow.F_b[:, 2:Nt]), wid=to(bow.wid[:, 2:Nt]),
            phi_0=to(bow.phi_0), phi_1=to(bow.phi_1), mask=mask(bow_mask), **uH,
        )
    if consts.has_hammer:
        kwargs["hammer"] = dict(
            x_H=to(hammer.x_H), w_H=to(hammer.w_H), M_r=to(hammer.M_r),
            alpha=to(hammer.alpha), mask=mask(hammer_mask), **uH,
        )
    return args, kwargs


def process(state, bow, hammer, bow_mask, hammer_mask, consts: SimConsts, Nt,
            device):
    """Run one batch through the fused string kernel (steps 2..Nt-1).

    Returns numpy ``(uout, zout, state_u, state_z, v_r, F_H, u_H, sig0,
    sig1)``; the state fields are ``(B, Nt, M)`` with the two initial rows
    first, or ``None`` without ``consts.collect_state``.
    """
    args, kwargs = kernel_inputs(state, consts, Nt, device, bow, hammer,
                                 bow_mask, hammer_mask)
    uout_d, zout_d, aux = string_chunked(*args, **kwargs)
    np_dt = state.u0.dtype
    B, T = uout_d.shape
    uout = uout_d.cpu().numpy()
    zout = zout_d.cpu().numpy()
    if consts.has_bow or consts.has_hammer:
        v_r = aux["v_r"].cpu().numpy()
        F_H = aux["F_H"].cpu().numpy()
        u_H = aux["u_H"].cpu().numpy() / consts.k
    else:
        # excitation-free run: zero probe traces and the free ballistic
        # hammer ramp in closed form (engine fast-path semantics)
        vstep = hammer.u_H[:, 1] - hammer.u_H[:, 0]
        n = np.arange(1, T + 1)[None, :]
        u_H = ((hammer.u_H[:, 1][:, None] + n * vstep[:, None]) / consts.k).astype(np_dt)
        v_r = np.zeros((B, T), np_dt)
        F_H = np.zeros((B, T), np_dt)
    gamma = 2.0 * state.f0[:, -1]
    sig0, sig1 = audio.T60_to_sigma(state.T60, gamma, state.kappa * gamma)
    if not consts.collect_state:
        return uout, zout, None, None, v_r, F_H, u_H, sig0, sig1
    u1, u2 = args[5], args[6]
    z0 = torch.zeros((B, 2, consts.M_l), dtype=u1.dtype, device=u1.device)
    state_u = torch.cat(
        [u2[:, None], u1[:, None], aux["state_u"].transpose(0, 1)], dim=1)
    state_z = torch.cat([z0, aux["state_z"].transpose(0, 1)], dim=1)
    return (uout, zout, state_u.cpu().numpy(), state_z.cpu().numpy(),
            v_r, F_H, u_H, sig0, sig1)


def draw_params(model_name, sr, theta_t, length, batch_size, f0_inf,
                alpha_inf, lambda_c, *, string_kwargs=None, hammer_kwargs=None,
                bow_kwargs=None, precision="single", randomize_each="batch",
                manufactured=False, rng=None):
    """Sample one batch's instruments (reference simulate.py:121-163).
    Returns ``(string, bow, hammer, bow_mask, hammer_mask, pluck_mask)``."""
    rng = rng or np.random.default_rng()
    k = 1.0 / sr
    pluck_batch = (
        True if model_name.endswith("pluck") else None if model_name == "random" else False
    )
    bow_mask, hammer_mask = prm.get_masks(rng, model_name, batch_size)
    pluck_mask = ~(bow_mask | hammer_mask)
    string = prm.sample_string(
        rng, k=k, theta_t=theta_t, lambda_c=lambda_c, sr=sr, length=length,
        f0_inf=f0_inf, alpha_inf=alpha_inf, batch_size=batch_size,
        precision=precision, pluck_batch=pluck_batch, pluck_mask=pluck_mask,
        hammer_mask=hammer_mask, randomize_each=randomize_each,
        manufactured=manufactured, **(string_kwargs or {}),
    )
    bow = prm.sample_bow(
        rng, sr=sr, length=length, batch_size=batch_size, precision=precision,
        randomize_each=randomize_each, **(bow_kwargs or {}),
    )
    hammer = prm.sample_hammer(
        rng, sr=sr, length=length, batch_size=batch_size, precision=precision,
        k=k, randomize_each=randomize_each, **(hammer_kwargs or {}),
    )
    return string, bow, hammer, bow_mask, hammer_mask, pluck_mask


def sim_consts(string, bow_mask, hammer_mask, sr, theta_t, lambda_c,
               relative_order=4, surface_integral=False, manufactured=False,
               collect_state=True):
    return SimConsts(
        k=1.0 / sr, theta_t=float(theta_t), lambda_c=float(lambda_c),
        relative_error=float(relative_order),
        M_t=string.Nx_t + 1, M_l=string.Nx_l + 1,
        surface_integral=bool(surface_integral),
        manufactured=bool(manufactured), collect_state=collect_state,
        has_bow=bool(np.any(bow_mask)), has_hammer=bool(np.any(hammer_mask)),
    )


def simulate(model_name, sr, theta_t, length, batch_size, f0_inf, alpha_inf,
             lambda_c, cpu=False, load_config=None, string_kwargs=None,
             hammer_kwargs=None, bow_kwargs=None, precision="single",
             relative_order=4, surface_integral=False, randomize_each="batch",
             manufactured=False, rng=None, collect_state=True):
    """Draw one batch and simulate it (reference simulate.py:121-217).

    Returns ``(results, (string, bow, hammer, [k, theta_t, lambda_c],
    consts), (bow_mask, hammer_mask, pluck_mask), device)``.
    """
    if load_config is not None:
        _not_ported("preset loading (task.load_config)", "Queue 1 item 5")
    string, bow, hammer, bow_mask, hammer_mask, pluck_mask = draw_params(
        model_name, sr, theta_t, length, batch_size, f0_inf, alpha_inf,
        lambda_c, string_kwargs=string_kwargs, hammer_kwargs=hammer_kwargs,
        bow_kwargs=bow_kwargs, precision=precision,
        randomize_each=randomize_each, manufactured=manufactured, rng=rng,
    )
    consts = sim_consts(
        string, bow_mask, hammer_mask, sr, theta_t, lambda_c,
        relative_order=relative_order, surface_integral=surface_integral,
        manufactured=manufactured, collect_state=collect_state,
    )
    device = select_device(cpu, precision)
    results = process(string, bow, hammer, bow_mask, hammer_mask, consts,
                      int(length * sr), device)
    k = 1.0 / sr
    return (results, (string, bow, hammer, [k, theta_t, lambda_c], consts),
            (bow_mask, hammer_mask, pluck_mask), device)


def task_kwargs(task):
    """``theta_t`` and the sampler keyword sets of a composed ``task``
    config (reference simulate.py:219-262)."""
    sr = task.sr

    def _cond(cond_list, key):
        vals = [d[key] for d in cond_list if key in d and d[key] is not None]
        return vals[0] if vals else None

    if task.sampling_kappa == "fix":
        kappa_max = _cond(task.string_condition, "kappa_fixed")
    else:
        kappa_max = _cond(task.string_condition, "kappa_max")
        if kappa_max is None:
            raise ValueError("Specify 'kappa_max' in task.string_condition")
    if task.sampling_f0 == "fix":
        f0_min = _cond(task.string_condition, "f0_fixed")
        if np.ndim(f0_min) > 0:
            f0_min = min(f0_min)
    else:
        f0_min = _cond(task.string_condition, "f0_min")
    theta_t = (
        fdm.get_theta(kappa_max, f0_min, sr) if task.theta_t is None else task.theta_t
    )

    string_kwargs = dict(
        sampling_f0=task.sampling_f0 or "random",
        sampling_kappa=task.sampling_kappa or "random",
        sampling_alpha=task.sampling_alpha or "random",
        sampling_pickup=task.sampling_pickup or "random",
        sampling_T60=task.sampling_T60 or "random",
        precorrect=True if task.precorrect is None else task.precorrect,
    )

    def _collect(conds, into):
        for d in conds:
            ((key, val),) = d.items()
            if val is not None:
                into[key] = val
        return into

    _collect(task.string_condition, string_kwargs)
    _collect(task.pluck_condition, string_kwargs)
    return dict(
        theta_t=theta_t,
        string_kwargs=string_kwargs,
        hammer_kwargs=_collect(task.hammer_condition, {}),
        bow_kwargs=_collect(task.bow_condition, {}),
    )


def run(args, save_dir, model_name, n_samples):
    """Dataset-generation loop (reference simulate.py:219-456), classic
    archival contract.  Returns the per-batch simulate wall times."""
    task = args.task
    sr = task.sr
    if task.get("fuse_preprocess", False):
        _not_ported("fused preprocessing (task.fuse_preprocess=true)",
                    "Queue 1 item 1")
    if task.get("rescue_nan", True) and task.precision != "double":
        _not_ported("the NaN rescue ladder (task.rescue_nan=true)",
                    "Queue 1 item 4")
    if task.plot or task.plot_state:
        _not_ported("plots (task.plot / task.plot_state)", "Queue 1 item 12")
    if task.write_during_process:
        _not_ported("writing during the process (task.write_during_process)",
                    "Queue 1 item 2")
    kw = task_kwargs(task)
    theta_t = kw.pop("theta_t")

    rng = np.random.default_rng(args.proc.seed)
    time_log = []
    skip_stats = []
    os.makedirs(save_dir, exist_ok=True)
    collect_state = bool(task.save)
    bitrate = "PCM_24" if task.precision == "double" else "PCM_16"

    def save_item(b, d, excitation, uout, zout, state_u, state_z, v_r, F_H,
                  u_H, string, bow, hammer, Nx_t, Nx_l, sig0, sig1,
                  bow_mask, hammer_mask, pluck_mask, consts_list):
        os.makedirs(d, exist_ok=True)
        if task.normalize_output:
            u_n, gain = audio.ell_infty_normalize(uout[b])
            z_n = gain * zout[b]
        else:
            u_n, z_n = uout[b], zout[b]
        wavio.write(f"{d}/output-u.wav", u_n, sr, bitrate)
        wavio.write(f"{d}/output-z.wav", z_n, sr, bitrate)
        wavio.write(f"{d}/output.wav", u_n + z_n, sr, bitrate)
        if not task.save:
            return
        overall = dict(
            uout=uout[b], zout=zout[b], v_r_out=v_r[b], F_H_out=F_H[b],
            u_H_out=u_H[b], bow_mask=bow_mask[b], hammer_mask=hammer_mask[b],
            pluck_mask=pluck_mask[b], Nx_t=Nx_t[b], Nx_l=Nx_l[b],
            sig0=sig0[b], sig1=sig1[b],
            string_params=[
                string.kappa[b], string.alpha[b], string.u0[b][None, :],
                string.v0[b][None, :], string.p_a[b], string.f0[b],
                string.pos[b], string.T60[b], string.target_f0[b],
            ],
            hammer_params=[
                hammer.x_H[b], hammer.v_H[b], hammer.u_H[b], hammer.w_H[b],
                hammer.M_r[b], hammer.alpha[b],
            ],
            bow_params=[
                bow.x_b[b], bow.v_b[b], bow.F_b[b], bow.phi_0[b],
                bow.phi_1[b], bow.wid[b],
            ],
            state_u=state_u[b, :, : int(Nx_t[b].max()) + 1],
            state_z=state_z[b, :, : int(Nx_l[b].max()) + 1],
        )
        ms.save_simulation_data(d, excitation, overall, consts_list)

    with concurrent.futures.ThreadPoolExecutor(
        max_workers=max(int(args.proc.num_workers), 1)
    ) as pool:
        pending = []
        for it in range(n_samples):
            # bound the in-flight artifact queue to ~one iteration's items
            while len(pending) > task.batch_size:
                pending.pop(0).result()
            dx = str(it) if not task.randomize_name else ms.random_str(rng=rng)

            st = time.time()
            results, params_out, masks, device = simulate(
                model_name, sr, theta_t, task.length, task.batch_size,
                task.f0_inf, task.alpha_inf, task.lambda_c, args.proc.cpu,
                task.load_config, precision=task.precision,
                relative_order=task.relative_order,
                surface_integral=task.surface_integral,
                randomize_each=task.randomize_each,
                manufactured=task.manufactured, rng=rng,
                collect_state=collect_state, **kw,
            )
            proc_time = time.time() - st
            time_log.append(proc_time)
            log_name = "gpu_time" if device.type == "cuda" else "cpu_time"
            with open(f"{save_dir}/{log_name}.txt", "a") as f:
                f.write(f"{dx}\t{proc_time:.2f}\n")

            uout, zout, state_u, state_z, v_r, F_H, u_H, sig0, sig1 = results
            string, bow, hammer, consts_list, _ = params_out
            bow_mask, hammer_mask, pluck_mask = masks

            state_is_nan = np.isnan(uout.sum(-1))
            # every sample that does not reach disk is attributed to a named
            # cause; the rescue counters stay 0 until the ladder is ported
            batch_stat = {
                "it": it, "n": int(task.batch_size),
                "nan_first_pass": int(state_is_nan.sum()),
                "rescued_kernel_gmres": 0, "rescued_f64": 0,
            }
            uout = uout * ~state_is_nan[:, None]
            is_silent = audio.dB_RMS(uout) <= task.silence_threshold
            _, _, Nx_t, _, Nx_l, _ = fdm.get_derived_vars_host(
                string.f0, string.kappa[:, None], 1.0 / sr, theta_t,
                task.lambda_c, string.alpha[:, None], dtype=np.float32,
            )
            batch_stat["nan_final"] = int(state_is_nan.sum())
            batch_stat["silent"] = int((is_silent & ~state_is_nan).sum())
            batch_stat["written"] = 0
            skipped_detail = []
            for b in range(task.batch_size):
                if state_is_nan[b] or (task.skip_silence and is_silent[b]):
                    skipped_detail.append({
                        "b": int(b),
                        "why": "nan" if state_is_nan[b] else "silent",
                        "f0": round(float(string.f0[b, 2]), 2),
                        "alpha": round(float(string.alpha[b]), 3),
                        "p_a": round(float(string.p_a[b]), 4),
                    })
                    continue
                batch_stat["written"] += 1
                excitation = ",".join(
                    t for t, m in (("bow", bow_mask[b]), ("hammer", hammer_mask[b]),
                                   ("pluck", pluck_mask[b]))
                    if m
                )
                pending.append(pool.submit(
                    save_item, b, f"{save_dir}/{dx}-{b}", excitation, uout,
                    zout, state_u, state_z, v_r, F_H, u_H, string, bow, hammer,
                    Nx_t, Nx_l, sig0, sig1, bow_mask, hammer_mask, pluck_mask,
                    consts_list,
                ))
            if skipped_detail:
                batch_stat["skipped"] = skipped_detail
                print(
                    f"[simulate] batch {it}: wrote {batch_stat['written']}"
                    f"/{task.batch_size} (nan={batch_stat['nan_final']}, "
                    f"silent={batch_stat['silent']})", flush=True,
                )
            skip_stats.append(batch_stat)
            with open(f"{save_dir}/skip_stats.json", "w") as f:
                json.dump(skip_stats, f, indent=1)
        for fut in pending:
            fut.result()
    return time_log
