"""Background mesh estimation, SEP's Background equivalent (the port's
copy of celeste_jl_tpu/detection/background.py).

Grid of boxsize cells; per-cell sigma-clipped statistics with the SExtractor
mode estimator (2.5*median - 1.5*mean); 3x3 median filter across the mesh;
bilinear interpolation back to the full image. Mirrors what SEP.Background
provides to detection (SEP.jl:137-212, detection.jl:57-60).
"""

import numpy as np
from scipy import ndimage


class Background:
    def __init__(self, data, boxsize=(256, 256), filtersize=(3, 3),
                 sigclip=3.0, maxiter=5):
        data = np.asarray(data, dtype=np.float64)
        H, W = data.shape
        bh, bw = boxsize
        nh, nw = max(1, (H + bh - 1) // bh), max(1, (W + bw - 1) // bw)
        mesh_back = np.zeros((nh, nw))
        mesh_rms = np.zeros((nh, nw))
        for i in range(nh):
            for j in range(nw):
                cell = data[i * bh:(i + 1) * bh, j * bw:(j + 1) * bw]
                vals = cell[np.isfinite(cell)].ravel()
                if vals.size == 0:
                    mesh_back[i, j] = 0.0
                    mesh_rms[i, j] = 0.0
                    continue
                for _ in range(maxiter):
                    med = np.median(vals)
                    sd = vals.std()
                    if sd == 0:
                        break
                    keep = np.abs(vals - med) < sigclip * sd
                    if keep.all():
                        break
                    vals = vals[keep]
                mean, med, sd = vals.mean(), np.median(vals), vals.std()
                # SExtractor: crowded-field mode estimator
                mode = (2.5 * med - 1.5 * mean
                        if sd > 0 and abs(mean - med) / max(sd, 1e-30) < 0.3
                        else med)
                mesh_back[i, j] = mode
                mesh_rms[i, j] = sd
        fh, fw = filtersize
        if (fh > 1 or fw > 1) and mesh_back.size > 1:
            mesh_back = ndimage.median_filter(mesh_back, size=(fh, fw),
                                              mode="nearest")
            mesh_rms = ndimage.median_filter(mesh_rms, size=(fh, fw),
                                             mode="nearest")
        self.mesh_back = mesh_back
        self.mesh_rms = mesh_rms
        self.shape = (H, W)
        self.boxsize = (bh, bw)

    def _interp(self, mesh):
        H, W = self.shape
        bh, bw = self.boxsize
        nh, nw = mesh.shape
        if nh == 1 and nw == 1:
            return np.full((H, W), mesh[0, 0])
        ci = (np.arange(nh) + 0.5) * bh  # cell centers
        cj = (np.arange(nw) + 0.5) * bw
        ii = np.clip(np.interp(np.arange(H) + 0.5, ci, np.arange(nh)),
                     0, nh - 1)
        jj = np.clip(np.interp(np.arange(W) + 0.5, cj, np.arange(nw)),
                     0, nw - 1)
        i0 = np.floor(ii).astype(int)
        j0 = np.floor(jj).astype(int)
        i1 = np.minimum(i0 + 1, nh - 1)
        j1 = np.minimum(j0 + 1, nw - 1)
        fi = (ii - i0)[:, None]
        fj = (jj - j0)[None, :]
        return ((1 - fi) * (1 - fj) * mesh[np.ix_(i0, j0)]
                + (1 - fi) * fj * mesh[np.ix_(i0, j1)]
                + fi * (1 - fj) * mesh[np.ix_(i1, j0)]
                + fi * fj * mesh[np.ix_(i1, j1)])

    def back(self):
        return self._interp(self.mesh_back)

    def rms(self):
        return self._interp(self.mesh_rms)

    def global_back(self):
        return float(np.median(self.mesh_back))

    def global_rms(self):
        return float(np.median(self.mesh_rms))

    def subtract(self, data):
        return np.asarray(data, dtype=np.float64) - self.back()
