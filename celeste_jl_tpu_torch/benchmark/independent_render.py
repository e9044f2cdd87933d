"""Independent dense truth renderer for the accuracy suites (the port's
copy of celeste_jl_tpu/benchmark/independent_render.py).

The reference renders benchmark ground truth with an EXTERNAL renderer
(GalSim, benchmark/galsim/generate_test_image.py:1-436) so that a bug in the
model's forward renderer cannot cancel against itself in the scores. This
module is that renderer: a standalone numpy implementation of the
star/galaxy light model with NO imports from the package's models — the
Gaussian densities, covariance parameterization and galaxy profile
prototypes are all re-derived here from the reference's published math
(BivariateNormals.jl:29-43, model/light_source_model.jl:45-75), not shared
with models/fsm.py. A suite rendered with this module actually *tests* the
model renderer instead of assuming it.

Only the forward value path exists (no derivatives); everything is double
precision numpy on the host.
"""

import numpy as np

TWO_PI = 2.0 * np.pi

# Galaxy profile prototype GMMs: 8-component de Vaucouleurs + 6-component
# exponential, with the effective-radius corrections applied
# (model/light_source_model.jl:45-75). Typed in from the reference's
# literals independently of models/params.py.
_DEV_AMP = np.array([4.26347652e-2, 2.40127183e-1, 6.85907632e-1,
                     1.51937350, 2.83627243, 4.46467501, 5.72440830,
                     5.60989349])
_DEV_AMP = _DEV_AMP / _DEV_AMP.sum()
_DEV_VAR = np.array([2.23759216e-4, 1.00220099e-3, 4.18731126e-3,
                     1.69432589e-2, 6.84850479e-2, 2.87207080e-1,
                     1.33320254, 8.40215071]) / 1.078031 ** 2
_EXP_AMP = np.array([2.34853813e-3, 3.07995260e-2, 2.23364214e-1,
                     1.17949102, 4.33873750, 5.99820770])
_EXP_AMP = _EXP_AMP / _EXP_AMP.sum()
_EXP_VAR = np.array([1.20078965e-3, 8.84526493e-3, 3.91463084e-2,
                     1.39976817e-1, 4.60962500e-1, 1.50159566]) \
    / 0.928896 ** 2


def _shape_cov(axis_ratio, angle, scale):
    """Covariance of a rotated elliptical Gaussian: R(angle) diag(scale^2,
    (scale*axis_ratio)^2) R(angle)^T (BivariateNormals.jl:29-43)."""
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, -s], [s, c]])
    d = np.diag([scale ** 2, (scale * axis_ratio) ** 2])
    return rot @ d @ rot.T


def _mixture_image(H, W, means, covs, weights):
    """Dense evaluation of a 2-D Gaussian mixture on the full (H, W) pixel
    grid (1-based pixel centers), direct per-component loop."""
    x1 = np.arange(1, H + 1, dtype=np.float64)[:, None]
    x2 = np.arange(1, W + 1, dtype=np.float64)[None, :]
    out = np.zeros((H, W))
    for mean, cov, w in zip(means, covs, weights):
        det = cov[0, 0] * cov[1, 1] - cov[0, 1] * cov[1, 0]
        p11, p22 = cov[1, 1] / det, cov[0, 0] / det
        p12 = -cov[0, 1] / det
        dx1 = x1 - mean[0]
        dx2 = x2 - mean[1]
        quad = p11 * dx1 * dx1 + 2.0 * p12 * dx1 * dx2 + p22 * dx2 * dx2
        out += (w / (TWO_PI * np.sqrt(det))) * np.exp(-0.5 * quad)
    return out


def _psf_components(psf_packed):
    """Unpack a (K, 6) [alpha, mu1, mu2, s11, s12, s22] PSF mixture."""
    psf = np.asarray(psf_packed, dtype=np.float64)
    alphas = psf[:, 0]
    mus = psf[:, 1:3]
    covs = np.array([[[s11, s12], [s12, s22]]
                     for s11, s12, s22 in psf[:, 3:6]])
    return alphas, mus, covs


def render_star_nmgy(H, W, pixel_center, flux, psf_packed):
    """Expected nMgy image of a star: flux x the PSF mixture centered at the
    source's (1-based) pixel position."""
    alphas, mus, covs = _psf_components(psf_packed)
    means = mus + np.asarray(pixel_center, dtype=np.float64)[None, :]
    return flux * _mixture_image(H, W, means, covs, alphas)


def render_galaxy_nmgy(H, W, pixel_center, flux, psf_packed, gal_frac_dev,
                       gal_axis_ratio, gal_angle, gal_radius_px,
                       pixel_scale_jacobian=None):
    """Expected nMgy image of a galaxy: the (dev, exp) profile prototype
    mixture scaled by the shape covariance, convolved with the PSF mixture
    (convolution of Gaussians = sum of covariances)."""
    alphas, mus, covs = _psf_components(psf_packed)
    xixi = _shape_cov(gal_axis_ratio, gal_angle, gal_radius_px)
    if pixel_scale_jacobian is not None:
        j = np.asarray(pixel_scale_jacobian, dtype=np.float64)
        xixi = j @ xixi @ j.T
    eta = np.concatenate([gal_frac_dev * _DEV_AMP,
                          (1.0 - gal_frac_dev) * _EXP_AMP])
    nu = np.concatenate([_DEV_VAR, _EXP_VAR])
    ctr = np.asarray(pixel_center, dtype=np.float64)
    means, cc, ww = [], [], []
    for a, mu, cov in zip(alphas, mus, covs):
        for e, n in zip(eta, nu):
            means.append(mu + ctr)
            cc.append(cov + n * xixi)
            ww.append(a * e)
    return flux * _mixture_image(H, W, means, cc, ww)


def render_scene_nmgy(images, entries):
    """Expected nMgy images (sky NOT included) for a list of truth entries
    over a list of Image-like objects (needs .H/.W/.band/.psf/.world_to_pix;
    the coordinate transform is the image's own — independence is about the
    light model, not the WCS)."""
    out = []
    for img in images:
        acc = np.zeros((img.H, img.W))
        for ce in entries:
            ctr = np.asarray(img.world_to_pix(np.asarray(ce.pos, float)))
            if ce.is_star:
                acc += render_star_nmgy(img.H, img.W, ctr,
                                        ce.star_fluxes[img.band], img.psf)
            else:
                acc += render_galaxy_nmgy(
                    img.H, img.W, ctr, ce.gal_fluxes[img.band], img.psf,
                    float(ce.gal_frac_dev), float(ce.gal_axis_ratio),
                    float(ce.gal_angle), float(ce.gal_radius_px))
        out.append(acc)
    return out
