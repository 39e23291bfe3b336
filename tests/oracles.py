"""NumPy oracle implementations of the reference MATLAB math.

These are independent re-derivations (spatial/full-spectrum domain, plain
loops) of the algorithms in /root/reference, used to validate the fused
frequency-domain JAX implementations.  Everything is float64.
"""
from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# PSFs
# ---------------------------------------------------------------------------

def grid(size):
    offs = np.arange(size) - (size - 1) / 2.0
    v = offs[:, None] * np.ones((1, size))
    u = np.ones((size, 1)) * offs[None, :]
    return v, u


def np_gaussian_kernel(size, w1, w2, phi=0.0):
    v, u = grid(size)
    U = u * np.cos(phi) - v * np.sin(phi)
    V = u * np.sin(phi) + v * np.cos(phi)
    c = w1**2 * U**2 + w2**2 * V**2
    f = (w1 * w2) / (2 * np.pi) * np.exp(-c / 2)
    return f / f.sum()


def np_laplace_kernel(size, b):
    v, u = grid(size)
    f = (b**2 / 4) * np.exp(-b * (np.abs(v) + np.abs(u)))
    return f / f.sum()


def np_moffat_kernel(size, a, b):
    v, u = grid(size)
    r2 = v**2 + u**2
    f = a**2 * (r2 * a**2 / b + 1) ** (-(b + 2) / 2) / (2 * np.pi)
    return f / f.sum()


# ---------------------------------------------------------------------------
# Blur operator (full-spectrum, like the MATLAB drivers)
# ---------------------------------------------------------------------------

def np_otf(kernel, shape):
    M, N = shape
    s = kernel.shape[0]
    padded = np.zeros((M, N))
    padded[:s, :s] = kernel
    return np.fft.fft2(padded)


def np_blur(x, H):
    return np.real(np.fft.ifft2(H * np.fft.fft2(x)))


def np_blur_adj(x, H):
    return np.real(np.fft.ifft2(np.conj(H) * np.fft.fft2(x)))


# ---------------------------------------------------------------------------
# TV norm and Chambolle prox
# ---------------------------------------------------------------------------

def np_tv(x):
    dh = x - np.roll(x, 1, axis=1)
    dv = x - np.roll(x, 1, axis=0)
    return np.sum(np.sqrt(dh**2 + dv**2))


def _np_div(p1, p2):
    u = np.empty_like(p1)
    u[0] = p1[0]
    np.subtract(p1[1:-1], p1[:-2], out=u[1:-1])
    np.negative(p1[-1], out=u[-1])
    u[:, 0] += p2[:, 0]
    u[:, 1:-1] += p2[:, 1:-1]
    u[:, 1:-1] -= p2[:, :-2]
    u[:, -1] -= p2[:, -1]
    return u


def _np_grad(u):
    dux = np.zeros_like(u)
    np.subtract(u[1:], u[:-1], out=dux[:-1])
    duy = np.zeros_like(u)
    np.subtract(u[:, 1:], u[:, :-1], out=duy[:, :-1])
    return dux, duy


def np_chambolle(g, lam, max_iter, tau=0.249, tol=1e-3, duals=None):
    """Early-exit loop exactly like chambolle_prox_TV_stop.m:120-149."""
    if duals is None:
        px = np.zeros_like(g)
        py = np.zeros_like(g)
    else:
        px, py = (d.copy() for d in duals)
    g_over_lam = g / lam
    k = 0
    err = np.inf
    while True:
        k += 1
        u = _np_div(px, py)
        u -= g_over_lam
        upx, upy = _np_grad(u)
        tmp = np.sqrt(upx**2 + upy**2)
        err = np.sqrt(
            np.sum((tmp * px - upx) ** 2) + np.sum((tmp * py - upy) ** 2)
        )
        tmp *= tau
        tmp += 1.0
        px += tau * upx
        px /= tmp
        py += tau * upy
        py /= tmp
        if not (k < max_iter and err > tol):
            break
    f = g - lam * _np_div(px, py)
    return f, px, py, k, err


# ---------------------------------------------------------------------------
# One full SAPG iteration, spatial domain (SAPG_algorithm_Guassian.m:158-194)
# ---------------------------------------------------------------------------

def np_sapg_gaussian_step(
    X, proxGX, Z, y, theta, w1, w2, sigma2,
    psf_size, phi, gam, lam, d_scale, d_exp, ii,
    c_theta, c_w1, c_w2, c_sigma,
    boxes, fix, true_vals, sigma_init, chambolle_iters=25,
):
    """Returns (X_new, proxGX_new, theta_new, w1_new, w2_new, sigma_new, stats)."""
    d = X.size
    shape = X.shape

    def kern_and_grads(w1, w2):
        v, u = grid(psf_size)
        U = u * np.cos(phi) - v * np.sin(phi)
        V = u * np.sin(phi) + v * np.cos(phi)
        c = w1**2 * U**2 + w2**2 * V**2
        e = np.exp(-c / 2)
        f = (w1 * w2) / (2 * np.pi) * e
        dw1 = (w2 / (2 * np.pi)) * (1 - w1**2 * U**2) * e
        dw2 = (w1 / (2 * np.pi)) * (1 - w2**2 * V**2) * e
        S, S1, S2 = f.sum(), dw1.sum(), dw2.sum()
        k = f / S
        g1 = (dw1 * S - f * S1) / S**2
        g2 = (dw2 * S - f * S2) / S**2
        return k, g1, g2

    k, g1, g2 = kern_and_grads(w1, w2)
    H = np_otf(k, shape)
    dH1 = np_otf(g1, shape)
    dH2 = np_otf(g2, shape)

    gradF = np_blur_adj(np_blur(X, H) - y, H) / sigma2
    Xn = np.abs(X + gam * (proxGX - X) / lam - gam * gradF + np.sqrt(2 * gam) * Z)
    proxn, _, _, _, _ = np_chambolle(Xn, lam * theta, chambolle_iters)

    r = np_blur(Xn, H) - y
    tv = np_tv(Xn)
    G_t = d / theta - tv
    G_w1 = np.sum(np.real(np.fft.ifft2(dH1 * np.fft.fft2(Xn))) * r) / sigma2
    G_w2 = np.sum(np.real(np.fft.ifft2(dH2 * np.fft.fft2(Xn))) * r) / sigma2
    G_s = np.sum(r**2) / (2 * sigma2**2) - d / (2 * sigma2)

    delta = d_scale * ii ** (-d_exp) / d
    clip = lambda v, box: min(max(v, box[0]), box[1])
    theta_n = clip(theta + c_theta * delta * G_t, boxes["theta"])
    w1_n = clip(true_vals["w1"] if fix["w1"] else w1 - c_w1 * delta * G_w1, boxes["w1"])
    w2_n = clip(true_vals["w2"] if fix["w2"] else w2 - c_w2 * delta * G_w2, boxes["w2"])
    sigma_n = clip(
        sigma_init if fix["sigma"] else sigma2 + c_sigma * delta * G_s, boxes["sigma"]
    )
    logpi = -np.sum(r**2) / (2 * sigma2) - theta * tv
    stats = dict(G_t=G_t, G_w1=G_w1, G_w2=G_w2, G_s=G_s, logPi=logpi, tv=tv)
    return Xn, proxn, theta_n, w1_n, w2_n, sigma_n, stats


# ---------------------------------------------------------------------------
# Reference-quirk PSF gradients (quotient rule over the normalisation)
# ---------------------------------------------------------------------------

def np_gaussian_kernel_grads(size, w1, w2, phi=0.0):
    """Normalised anisotropic-Gaussian kernel + reference-formula grads
    (diff_fftgaus_w1.m / diff_fftgaus_w2.m, quotient rule over the
    normalisation as in Sum_gauss_psf.m)."""
    v, u = grid(size)
    U = u * np.cos(phi) - v * np.sin(phi)
    V = u * np.sin(phi) + v * np.cos(phi)
    c = w1**2 * U**2 + w2**2 * V**2
    e = np.exp(-c / 2)
    f = (w1 * w2) / (2 * np.pi) * e
    dw1 = (w2 / (2 * np.pi)) * (1 - w1**2 * U**2) * e
    dw2 = (w1 / (2 * np.pi)) * (1 - w2**2 * V**2) * e
    S, S1, S2 = f.sum(), dw1.sum(), dw2.sum()
    k = f / S
    g1 = (dw1 * S - f * S1) / S**2
    g2 = (dw2 * S - f * S2) / S**2
    return k, g1, g2


def np_laplace_kernel_grads(size, b):
    """Normalised Laplace kernel + reference-formula db grad
    (diff_laplace_b.m:9-13, sums from sum_lap_psf.m)."""
    v, u = grid(size)
    absr = np.abs(v) + np.abs(u)
    e = np.exp(-b * absr)
    f = (b**2 / 4.0) * e
    db = ((2.0 * b - b**2 * absr) / 4.0) * e
    S, Sb = f.sum(), db.sum()
    return f / S, (db * S - f * Sb) / S**2


def np_moffat_kernel_grads(size, a, b):
    """Normalised Moffat kernel + reference-formula grads.

    dk/da reproduces the reference's factor-2 quirk verbatim
    (diff_moffat_alpha.m:17: the second term's denominator carries a spurious
    factor 2 relative to the exact derivative); dk/db is the exact formula
    (diff_moffat_beta.m:18).  Sums per sum_mof_psf.m.
    """
    v, u = grid(size)
    r2 = v**2 + u**2
    base = r2 * a**2 / b + 1.0
    pw = base ** (-(b + 2.0) / 2.0)
    f = a**2 * pw / (2 * np.pi)
    da = (2.0 - ((b + 2.0) * r2 * a**2) / (2.0 * (b + r2 * a**2))) * pw * (
        a / (2 * np.pi)
    )
    db = (-np.log(base) + ((b + 2.0) * r2 * a**2) / (b * (b + r2 * a**2))) * pw * (
        a**2 / (4 * np.pi)
    )
    S, Sa, Sb = f.sum(), da.sum(), db.sum()
    k = f / S
    dka = (da * S - f * Sa) / S**2
    dkb = (db * S - f * Sb) / S**2
    return k, dka, dkb


# ---------------------------------------------------------------------------
# Full SAPG dynamics simulator (independent NumPy re-implementation of the
# reference estimators, used to certify PSF-parameter drift endpoints:
# Laplace anchor SAPG_algorithm_laplace.m:130-215 + run_laplace_demo.m:96-145,
# Moffat anchor SAPG_algorithm_moffat.m:135-205 + run_moffat_demo.m:122-185).
# Different implementation (spatial-domain NumPy, full-spectrum fft2) and
# different RNG stream than both MATLAB and the JAX package — agreement on
# trajectory endpoints certifies *method* behavior, not implementation.
# ---------------------------------------------------------------------------

_DYNAMICS_FAMILIES = {
    # name: (param names, inits, boxes, step consts, truth, bsnr range,
    #        lambda_max, gamma multiplier, Lf aggregation over the sigma² box)
    "gaussian": dict(
        # run_Gaussian_demo.m:32-89 (phi = 0; the published demo pins w1/w2
        # — this spec estimates them, the drift-study configuration)
        params=("w1", "w2"), inits=(0.5, 0.3),
        boxes=((0.1, 1.0), (0.1, 1.0)),
        c_params=(10.0, 10.0), c_theta=0.01, c_sigma2=1000.0,
        true_params=(0.4, 0.3), bsnr_range=(15.0, 45.0), lambda_max=2.0,
        gamma_mult=1.0, lf_agg=min, evmax_params=(1.0, 1.0),
        kernel_grads=lambda p, size: np_gaussian_kernel_grads(size, p[0], p[1]),
    ),
    "laplace": dict(
        params=("b",), inits=(0.1,), boxes=((1e-3, 1.0),),
        c_params=(100.0,), c_theta=0.01, c_sigma2=10_000.0,
        true_params=(0.3,), bsnr_range=(15.0, 45.0), lambda_max=0.1,
        gamma_mult=10.0, lf_agg=max, evmax_params=(1.0,),
        kernel_grads=lambda p, size: np_laplace_kernel_grads(size, p[0]),
    ),
    "moffat": dict(
        params=("alpha", "beta"), inits=(1.0, 10.0),
        boxes=((1e-2, 1.0), (0.1, 10.0)),
        c_params=(10.0, 10_000.0), c_theta=0.1, c_sigma2=10_000.0,
        true_params=(0.4, 3.5), bsnr_range=(18.0, 35.0), lambda_max=2.0,
        gamma_mult=1.0, lf_agg=min, evmax_params=(1.0, 5.0),
        kernel_grads=lambda p, size: np_moffat_kernel_grads(size, p[0], p[1]),
    ),
}


def np_sapg_dynamics_run(
    x, family, seed=0, samples=20_000, warmup=15_000, burn_in=None,
    psf_size=7, bsnr=30.0, th_init=0.01, chambolle_iters=25,
    theta_box=(1e-3, 1.0), d_exp=0.8, progress=None, fast=False,
    psf_log_scale=False,
):
    """Run the reference's full SAPG dynamics (warm-up + main loop + burn-in
    EB means) for the Laplace or Moffat family on image ``x``.

    ``fast=True`` composes A/Aᵀ in the frequency domain (one fft2 + ifft2
    instead of four transforms per operator pair) — mathematically identical
    for an exact FFT-diagonal operator, differing only in ~1e-16 rounding;
    used for the long 512² certification runs.

    Returns a dict with iterate traces and ``*_EB`` means, mirroring the
    MATLAB ``results`` struct fields used for certification.
    """
    spec = _DYNAMICS_FAMILIES[family]
    rng = np.random.default_rng(seed)
    x = np.asarray(x, dtype=np.float64)
    d = x.size
    shape = x.shape
    if burn_in is None:
        burn_in = (samples * 80) // 100

    def otfs(params):
        k, *grads = spec["kernel_grads"](params, psf_size)
        return np_otf(k, shape), [np_otf(g, shape) for g in grads]

    # evMax via the reference's power iteration at its hard-coded probe params
    # (run_moffat_demo.m:140 probes (1,5); run_laplace_demo.m:110 probes b=1)
    H_probe, _ = otfs(spec["evmax_params"])
    v = rng.standard_normal(shape)
    v /= np.linalg.norm(v)
    val, prev = 1.0, 1.0
    for _ in range(10_000):
        v = np_blur_adj(np_blur(v, H_probe), H_probe)
        val = np.linalg.norm(v)
        if abs(val - prev) / prev < 1e-4:
            break
        prev = val
        v /= val
    ev_max = val

    # Observation synthesis at BSNR (run_laplace_demo.m:115-126)
    H_true, _ = otfs(spec["true_params"])
    Ax = np_blur(x, H_true)
    pw = np.linalg.norm(Ax - Ax.mean())
    sigma = pw / np.sqrt(d * 10 ** (bsnr / 10))
    bsnr_lo, bsnr_hi = spec["bsnr_range"]
    s_lo = pw / np.sqrt(d * 10 ** (bsnr_lo / 10))   # "sigma_min" (larger σ)
    s_hi = pw / np.sqrt(d * 10 ** (bsnr_hi / 10))
    sigma2_init = (s_lo**2 + s_hi**2) / 2.0
    sigma2_box = (min(s_lo**2, s_hi**2), max(s_lo**2, s_hi**2))
    y = Ax + sigma * rng.standard_normal(shape)

    # MYULA constants (run_*_demo.m: λ=min(5/Lf,λmax); γ=frac·γmax, Laplace 10×)
    lf = spec["lf_agg"](ev_max**2 / s_lo**2, ev_max**2 / s_hi**2)
    lam = min(5.0 / lf, spec["lambda_max"])
    gam = spec["gamma_mult"] * 0.98 / (lf + 1.0 / lam)
    d_scale = 0.01 / th_init

    clip = lambda v, box: min(max(v, box[0]), box[1])

    # --- Warm-up at fixed hyperparameters (SAPG_algorithm_*.m warm loop) ----
    params = list(spec["inits"])
    H, dHs = otfs(params)
    theta, sigma2 = th_init, sigma2_init
    X = y.copy()
    yhat = np.fft.fft2(y)

    def grad_f(X, H, sigma2):
        if fast:
            Xhat = np.fft.fft2(X)
            return np.real(
                np.fft.ifft2(np.conj(H) * (H * Xhat - yhat))
            ) / sigma2
        return np_blur_adj(np_blur(X, H) - y, H) / sigma2

    proxGX, _, _, _, _ = np_chambolle(X, lam * theta, chambolle_iters)
    for ii in range(2, warmup + 1):
        gradF = grad_f(X, H, sigma2)
        X = np.abs(
            X + gam * (proxGX - X) / lam - gam * gradF
            + np.sqrt(2 * gam) * rng.standard_normal(shape)
        )
        proxGX, _, _, _, _ = np_chambolle(X, lam * theta, chambolle_iters)
        if progress and ii % progress == 0:
            print(f"warmup {ii}/{warmup}", flush=True)

    # --- Main SAPG loop (SAPG_algorithm_moffat.m:160-205 structure) --------
    thetas = np.zeros(samples + 1)
    sigmas = np.zeros(samples + 1)
    ptraces = {p: np.zeros(samples + 1) for p in spec["params"]}
    logpis = np.zeros(samples + 1)
    thetas[1], sigmas[1] = theta, sigma2
    for j, p in enumerate(spec["params"]):
        ptraces[p][1] = params[j]

    for ii in range(2, samples + 1):
        Z = rng.standard_normal(shape)
        gradF = grad_f(X, H, sigma2)
        X = np.abs(
            X + gam * (proxGX - X) / lam - gam * gradF + np.sqrt(2 * gam) * Z
        )
        proxGX, _, _, _, _ = np_chambolle(X, lam * theta, chambolle_iters)

        Xhat = np.fft.fft2(X)
        r = np.real(np.fft.ifft2(H * Xhat)) - y
        tv = np_tv(X)
        G_t = d / theta - tv
        G_ps = [
            np.sum(np.real(np.fft.ifft2(dH * Xhat)) * r) / sigma2 for dH in dHs
        ]
        G_s = np.sum(r**2) / (2 * sigma2**2) - d / (2 * sigma2)
        logpis[ii] = -np.sum(r**2) / (2 * sigma2) - theta * tv

        delta = d_scale * ii ** (-d_exp) / d
        theta = clip(theta + spec["c_theta"] * delta * G_t, theta_box)
        for j, p in enumerate(spec["params"]):
            if psf_log_scale:
                # log-space extension probe (matches estimator.psf_log_scale:
                # chain-rule factor p, box clipped in log space)
                lo, hi = spec["boxes"][j]
                lp = np.log(params[j]) - spec["c_params"][j] * delta * G_ps[j] * params[j]
                params[j] = np.exp(clip(lp, (np.log(lo), np.log(hi))))
            else:
                params[j] = clip(
                    params[j] - spec["c_params"][j] * delta * G_ps[j], spec["boxes"][j]
                )
        sigma2 = clip(sigma2 + spec["c_sigma2"] * delta * G_s, sigma2_box)

        thetas[ii], sigmas[ii] = theta, sigma2
        for j, p in enumerate(spec["params"]):
            ptraces[p][ii] = params[j]
        H, dHs = otfs(params)
        if progress and ii % progress == 0:
            print(
                f"sapg {ii}/{samples} theta={theta:.4g} "
                + " ".join(f"{p}={ptraces[p][ii]:.4g}" for p in spec["params"])
                + f" sigma2={sigma2:.4g}", flush=True,
            )

    out = dict(
        thetas=thetas[1:], sigmas=sigmas[1:], logPiTrace=logpis[2:],
        theta_EB=float(np.mean(thetas[burn_in:samples + 1])),
        sigma2_EB=float(np.mean(sigmas[burn_in:samples + 1])),
        sigma2_true=float(sigma**2), sigma2_init=float(sigma2_init),
        lam=lam, gam=gam, ev_max=float(ev_max),
    )
    for p in spec["params"]:
        out[p + "s"] = ptraces[p][1:]
        out[p + "_EB"] = float(np.mean(ptraces[p][burn_in:samples + 1]))
    return out


# ---------------------------------------------------------------------------
# Generic C-SALSA (CSALSA_v2.m:462-545): min phi(P^T x) s.t. ||Ax-y|| <= eps
# with caller Psi/Phi, P/PT analysis pair, TV-initialization mode, the four
# stopping criteria, and mu-continuation — a direct NumPy port of the loop.
# ---------------------------------------------------------------------------

def np_csalsa_generic(y, A, AT, invLS, mu1, mu2, eps, *, psi=None, phi=None,
                      P=None, PT=None, tv_init=False, tv_iters=5, delta=1.0,
                      max_iter=200, tol=1e-3, stop_criterion=3, x0=None):
    if P is None:
        P = lambda x: x
        PT = lambda x: x
    if psi is None:
        psi = lambda v, tau: np.sign(v) * np.maximum(np.abs(v) - tau, 0.0)
    if phi is None:
        phi = np_tv if tv_init else (lambda x: np.sum(np.abs(x)))

    aty = AT(y)
    x = np.zeros_like(aty) if x0 is None else np.array(x0, dtype=aty.dtype)
    u = np.zeros_like(PT(x))
    bu = np.zeros_like(u)
    v = np.zeros_like(y)
    bv = np.zeros_like(y)
    pux = np.zeros_like(u)
    puy = np.zeros_like(u)
    prev_obj = phi(x)
    prev_crit = np.linalg.norm(A(x) - y)
    objs, crits, d1s, d2s = [], [], [], []
    n = 0
    for k in range(max_iter):
        xprev = x
        r = mu1 * P(u + bu) + mu2 * AT(y + v + bv)
        x = invLS(r, mu1, mu2)
        ptx = PT(x)
        if tv_init:
            u, pux, puy, _, _ = np_chambolle(
                np.real(ptx - bu), 1.0 / mu1, tv_iters, duals=(pux, puy)
            )
        else:
            u = psi(ptx - bu, 1.0 / mu1)
        Ax = A(x)
        ve = Ax - y - bv
        n_ve = np.linalg.norm(ve)
        v = ve if n_ve <= eps else ve / n_ve * eps
        bv = bv - (Ax - y - v)
        bu = bu - (ptx - u)
        crit = np.linalg.norm(Ax - y)
        # objective evaluated at x, NOT P^T x (CSALSA_v2.m:499 quirk)
        obj = phi(x)
        objs.append(obj)
        crits.append(crit)
        d1s.append(np.linalg.norm(Ax - y - v))
        d2s.append(np.linalg.norm(ptx - u))
        mu1 *= delta
        mu2 *= delta
        n += 1
        # stop checked from the first pass (outer = 2 compares against the
        # stored initial objective/criterion, CSALSA_v2.m:520-545)
        if stop_criterion == 1:
            sc_ok = abs(obj - prev_obj) / obj < tol
        elif stop_criterion == 2:
            sc_ok = np.linalg.norm(x - xprev) / np.linalg.norm(x) < tol
        elif stop_criterion == 3:
            sc_ok = abs(crit - prev_crit) / crit < tol
        else:
            sc_ok = k + 2 >= tol
        prev_obj, prev_crit = obj, crit
        if sc_ok and crit <= eps:
            break
    return dict(
        x=x, objective=np.array(objs), criterion=np.array(crits),
        distance1=np.array(d1s), distance2=np.array(d2s), n_iters=n,
    )


# ---------------------------------------------------------------------------
# SALSA (SALSA_v2.m:423-440 with TV initialization, x0 = 0)
# ---------------------------------------------------------------------------

def np_salsa(y, H, tau, mu, max_iter, tol=1e-5, tv_iters=10, x_true=None):
    ATy = np_blur_adj(y, H)
    inv_filter = 1.0 / (np.abs(H) ** 2 + mu)
    invLS = lambda v: np.real(np.fft.ifft2(inv_filter * np.fft.fft2(v)))
    thresh = tau / mu

    x = np.zeros_like(y)
    u = np.zeros_like(y)
    bu = np.zeros_like(y)
    pux = np.zeros_like(y)
    puy = np.zeros_like(y)

    resid = y - np_blur(x, H)
    objective = [0.5 * np.sum(resid**2) + tau * np_tv(u)]
    mses = [np.sum((x - x_true) ** 2) / x.size] if x_true is not None else []
    distance, criterion = [], []
    n_iters = 0
    for outer in range(1, max_iter + 1):
        xprev = x
        u, pux, puy, _, _ = np_chambolle(
            np.real(x - bu), thresh, tv_iters, duals=(pux, puy)
        )
        r = ATy + mu * (u + bu)
        x = invLS(r)
        bu = bu + (u - x)
        resid = y - np_blur(x, H)
        objective.append(0.5 * np.sum(resid**2) + tau * np_tv(u))
        if x_true is not None:
            mses.append(np.sum((x - x_true) ** 2) / x.size)
        distance.append(
            np.linalg.norm(x - u) / np.sqrt(np.sum(x**2) + np.sum(u**2))
        )
        n_iters = outer
        if outer > 1:
            crit = abs(objective[-1] - objective[-2]) / objective[-2]
            criterion.append(crit)
            if crit < tol:
                break
    return dict(
        x=x, objective=np.array(objective), distance=np.array(distance),
        mses=np.array(mses), criterion=np.array(criterion), n_iters=n_iters,
    )


# ---------------------------------------------------------------------------
# Legacy test-signal / trace helpers (SALSA/calctv.m, monotonize.m,
# sparsePWS.m, MakeRDSquares.m) — literal loop ports of the MATLAB math.
# ---------------------------------------------------------------------------

def np_calctv(X):
    dh = np.concatenate([np.diff(X, axis=1), np.zeros((X.shape[0], 1))], axis=1)
    dv = np.concatenate([np.diff(X, axis=0), np.zeros((1, X.shape[1]))], axis=0)
    mag = np.sqrt(dh**2 + dv**2)
    return mag.sum(), mag.max()


def np_monotonize(x):
    y = np.empty_like(np.asarray(x, dtype=float))
    y[0] = x[0]
    offset = 0.0
    for k in range(1, len(x)):
        if x[k] < x[k - 1]:
            offset += x[k - 1] - x[k]
        y[k] = x[k] + offset
    return y


def np_sparse_pws(corners, N, n):
    """corners: (L, 2) int array of MATLAB-style 1-based round(rand*N) draws."""
    x = np.zeros((N, N))
    for xc in corners:
        r0, r1 = max(xc[0], 1), min(xc[0] + n - 1, N)
        c0, c1 = max(xc[1], 1), min(xc[1] + n - 1, N)
        x[r0 - 1:r1, c0 - 1:c1] = 1.0
    return x


def np_rd_squares(draws, N, nbs, dyna):
    """draws: (nbs, 5) uniforms standing in for MATLAB's rand stream."""
    lmin, lmax = 8, N // 4
    x = np.zeros((N, N))
    for u in draws:
        ndx = int(1 + np.floor((N - lmax - 1) * u[0]))
        lx = int(min(N - ndx - 1, np.floor(lmin + (lmax - lmin) * u[1])))
        ndy = int(1 + np.floor((N - lmax - 1) * u[2]))
        ly = int(min(N - ndy - 1, np.floor(lmin + (lmax - lmin) * u[3])))
        x[ndx - 1:ndx + lx - 1, ndy - 1:ndy + ly - 1] = 1 + 10 ** (dyna / 20.0) * u[4]
    ind = x > 0.5
    x[ind] -= x[ind].min()
    x[ind] = x[ind] / x[ind].max() * (10 ** (dyna / 20.0) - 1) + 1
    return x
