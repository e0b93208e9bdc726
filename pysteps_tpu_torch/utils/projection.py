"""
Dependency-free map projections (forward and inverse) for the PROJ.4
strings produced by the radar importers: the port's own copy of
``pysteps_tpu/utils/projection.py``, numpy on the host as there.

The reference delegates coordinate transforms to pyproj (e.g.
pysteps/io/exporters.py:563-565 computes lon/lat grids for the CF-NetCDF
writer; pysteps/utils/reprojection.py uses rasterio/pyproj).  pyproj is
not available in this environment, so the needed projections are
implemented here directly from the standard ellipsoidal formulas (Snyder,
"Map Projections — A Working Manual", USGS PP 1395) with NumPy:

- ``longlat``           identity (degrees)
- ``merc``              Mercator (ellipsoidal, lat_ts or k_0)
- ``stere``             polar stereographic (ellipsoidal, lat_0 = ±90)
- ``aea``               Albers equal-area conic (ellipsoidal)
- ``tmerc`` / ``utm``   transverse Mercator (series to n^4) / UTM zones
- ``somerc``            Swiss oblique Mercator (CH1903 / LV03-style)
- ``aeqd``              azimuthal equidistant (spherical)
- ``laea``              Lambert azimuthal equal-area (ellipsoidal oblique)

All functions are vectorized over NumPy arrays.  ``Proj`` mimics the
pyproj.Proj call convention: ``Proj(proj4str)(x, y, inverse=True)``.
"""

import math

import numpy as np

from pysteps_tpu_torch.exceptions import MissingOptionalDependency

# name -> (a, rf); rf = None means sphere
_ELLIPSOIDS = {
    "WGS84": (6378137.0, 298.257223563),
    "GRS80": (6378137.0, 298.257222101),
    "bessel": (6377397.155, 299.1528128),
    "intl": (6378388.0, 297.0),
    "sphere": (6370997.0, None),
    "WGS72": (6378135.0, 298.26),
    "clrk66": (6378206.4, 294.9786982),
    "krass": (6378245.0, 298.3),
}

_DEG = math.pi / 180.0


def parse_proj4(proj4str):
    """PROJ.4 string -> dict of key: str|float (no pyproj)."""
    params = {}
    for token in str(proj4str).split():
        token = token.lstrip("+")
        if "=" in token:
            key, _, val = token.partition("=")
            try:
                params[key] = float(val)
            except ValueError:
                params[key] = val
        else:
            params[token] = True
    return params


def _ellipsoid(params):
    """Return (a, e, e2) from proj params (a/b, a/rf, ellps, R, datum)."""
    if "R" in params:
        return float(params["R"]), 0.0, 0.0
    a = params.get("a")
    b = params.get("b")
    rf = params.get("rf")
    if a is None:
        name = params.get("ellps") or {"WGS84": "WGS84"}.get(
            params.get("datum"), None
        )
        if name is None and params.get("datum") == "WGS84":
            name = "WGS84"
        a, rf_tab = _ELLIPSOIDS.get(name or "WGS84", _ELLIPSOIDS["WGS84"])
        if rf is None:
            rf = rf_tab
    a = float(a)
    if b is not None:
        e2 = 1.0 - (float(b) / a) ** 2
    elif rf in (None, 0):
        e2 = 0.0
    else:
        f = 1.0 / float(rf)
        e2 = f * (2.0 - f)
    return a, math.sqrt(e2), e2


def _phi_from_chi(chi, e2):
    """Conformal latitude -> geodetic latitude (Snyder 3-5 series)."""
    e4, e6, e8 = e2**2, e2**3, e2**4
    return (
        chi
        + (e2 / 2 + 5 * e4 / 24 + e6 / 12 + 13 * e8 / 360) * np.sin(2 * chi)
        + (7 * e4 / 48 + 29 * e6 / 240 + 811 * e8 / 11520) * np.sin(4 * chi)
        + (7 * e6 / 120 + 81 * e8 / 1120) * np.sin(6 * chi)
        + (4279 * e8 / 161280) * np.sin(8 * chi)
    )


def _t(phi, e):
    """Snyder 15-9: isometric colatitude function for polar stereographic."""
    esin = e * np.sin(phi)
    return np.tan(math.pi / 4 - phi / 2) / ((1 - esin) / (1 + esin)) ** (e / 2)


def _m(phi, e2):
    """Snyder 14-15."""
    return np.cos(phi) / np.sqrt(1 - e2 * np.sin(phi) ** 2)


def _q(phi, e, e2):
    """Snyder 3-12 (authalic q)."""
    sinp = np.sin(phi)
    if e == 0:
        return 2.0 * sinp
    esin = e * sinp
    return (1 - e2) * (
        sinp / (1 - esin**2) - (1 / (2 * e)) * np.log((1 - esin) / (1 + esin))
    )


def _phi_from_q(q, e, e2):
    """Invert Snyder 3-12 by Newton iteration (Snyder 3-16)."""
    phi = np.arcsin(np.clip(q / 2.0, -1.0, 1.0))
    if e == 0:
        return phi
    for _ in range(8):
        sinp = np.sin(phi)
        esin = e * sinp
        dphi = (
            (1 - esin**2) ** 2
            / (2 * np.cos(phi))
            * (
                q / (1 - e2)
                - sinp / (1 - esin**2)
                + (1 / (2 * e)) * np.log((1 - esin) / (1 + esin))
            )
        )
        phi = phi + dphi
    return phi


class _Base:
    def __init__(self, params):
        self.params = params
        self.a, self.e, self.e2 = _ellipsoid(params)
        self.x0 = float(params.get("x_0", 0.0))
        self.y0 = float(params.get("y_0", 0.0))
        self.lon0 = float(params.get("lon_0", 0.0)) * _DEG
        self.lat0 = float(params.get("lat_0", 0.0)) * _DEG
        self.k0 = float(params.get("k", params.get("k_0", 1.0)))
        # +units=km etc.
        self.to_m = {"m": 1.0, "km": 1000.0}.get(params.get("units", "m"), 1.0)

    def forward(self, lon, lat):
        lam = np.asarray(lon, float) * _DEG
        phi = np.asarray(lat, float) * _DEG
        x, y = self._fwd(lam, phi)
        return (x + self.x0) / self.to_m, (y + self.y0) / self.to_m

    def inverse(self, x, y):
        x = np.asarray(x, float) * self.to_m - self.x0
        y = np.asarray(y, float) * self.to_m - self.y0
        lam, phi = self._inv(x, y)
        lam = (lam + math.pi) % (2 * math.pi) - math.pi
        return lam / _DEG, phi / _DEG


class _LongLat(_Base):
    def forward(self, lon, lat):
        return np.asarray(lon, float), np.asarray(lat, float)

    def inverse(self, x, y):
        return np.asarray(x, float), np.asarray(y, float)


class _Mercator(_Base):
    """Snyder ch. 7 (ellipsoidal)."""

    def __init__(self, params):
        super().__init__(params)
        if "lat_ts" in params:
            phits = float(params["lat_ts"]) * _DEG
            self.k0 = _m(phits, self.e2)

    def _fwd(self, lam, phi):
        x = self.a * self.k0 * (lam - self.lon0)
        y = -self.a * self.k0 * np.log(_t(phi, self.e))
        return x, y

    def _inv(self, x, y):
        lam = self.lon0 + x / (self.a * self.k0)
        t = np.exp(-y / (self.a * self.k0))
        chi = math.pi / 2 - 2 * np.arctan(t)
        return lam, _phi_from_chi(chi, self.e2)


class _PolarStereographic(_Base):
    """Snyder ch. 21 (ellipsoidal, lat_0 = +-90 only — the radar cases)."""

    def __init__(self, params):
        super().__init__(params)
        if abs(abs(self.lat0) - math.pi / 2) > 1e-9:
            raise MissingOptionalDependency(
                "non-polar stereographic needs pyproj (not available)"
            )
        self.south = self.lat0 < 0
        e, e2 = self.e, self.e2
        if "lat_ts" in params:
            phits = abs(float(params["lat_ts"])) * _DEG
            # Snyder 21-34: rho = a * m(ts) * t / t(ts)
            self.rho_factor = self.a * _m(phits, e2) / _t(phits, e)
        else:
            # Snyder 21-33 with scale k0 at the pole
            self.rho_factor = (
                2
                * self.a
                * self.k0
                / math.sqrt((1 + e) ** (1 + e) * (1 - e) ** (1 - e))
            )

    def _fwd(self, lam, phi):
        if self.south:
            lam, phi = -lam, -phi
            lon0 = -self.lon0
        else:
            lon0 = self.lon0
        rho = self.rho_factor * _t(phi, self.e)
        x = rho * np.sin(lam - lon0)
        y = -rho * np.cos(lam - lon0)
        if self.south:
            x, y = -x, -y
        return x, y

    def _inv(self, x, y):
        if self.south:
            x, y = -x, -y
            lon0 = -self.lon0
        else:
            lon0 = self.lon0
        rho = np.hypot(x, y)
        t = rho / self.rho_factor
        chi = math.pi / 2 - 2 * np.arctan(t)
        phi = _phi_from_chi(chi, self.e2)
        lam = lon0 + np.arctan2(x, -y)
        if self.south:
            lam, phi = -lam, -phi
        return lam, phi


class _Albers(_Base):
    """Snyder ch. 14 (ellipsoidal)."""

    def __init__(self, params):
        super().__init__(params)
        phi1 = float(params.get("lat_1", 0.0)) * _DEG
        phi2 = float(params.get("lat_2", phi1 / _DEG)) * _DEG
        e, e2 = self.e, self.e2
        m1, m2 = _m(phi1, e2), _m(phi2, e2)
        q1, q2 = _q(phi1, e, e2), _q(phi2, e, e2)
        if abs(phi1 - phi2) < 1e-10:
            self.n = math.sin(phi1)
        else:
            self.n = (m1**2 - m2**2) / (q2 - q1)
        self.C = m1**2 + self.n * q1
        self.rho0 = self.a * math.sqrt(self.C - self.n * _q(self.lat0, e, e2)) / self.n

    def _rho(self, phi):
        return self.a * np.sqrt(self.C - self.n * _q(phi, self.e, self.e2)) / self.n

    def _fwd(self, lam, phi):
        theta = self.n * (lam - self.lon0)
        rho = self._rho(phi)
        return rho * np.sin(theta), self.rho0 - rho * np.cos(theta)

    def _inv(self, x, y):
        yy = self.rho0 - y
        rho = np.hypot(x, yy)
        if self.n < 0:
            rho, x, yy = -rho, -x, -yy
        theta = np.arctan2(x, yy)
        q = (self.C - (rho * self.n / self.a) ** 2) / self.n
        phi = _phi_from_q(q, self.e, self.e2)
        return self.lon0 + theta / self.n, phi


class _TransverseMercator(_Base):
    """Snyder ch. 8 (ellipsoidal series); covers +proj=tmerc and +proj=utm."""

    def __init__(self, params):
        super().__init__(params)
        if params.get("proj") == "utm":
            zone = int(params["zone"])
            self.lon0 = (zone * 6 - 183) * _DEG
            self.k0 = 0.9996
            self.x0 = 500000.0
            self.y0 = 10000000.0 if params.get("south") else 0.0
        e2 = self.e2
        e4, e6 = e2**2, e2**3
        self._mc = (
            1 - e2 / 4 - 3 * e4 / 64 - 5 * e6 / 256,
            3 * e2 / 8 + 3 * e4 / 32 + 45 * e6 / 1024,
            15 * e4 / 256 + 45 * e6 / 1024,
            35 * e6 / 3072,
        )
        self.ep2 = e2 / (1 - e2)

    def _mdist(self, phi):
        c0, c1, c2, c3 = self._mc
        return self.a * (
            c0 * phi - c1 * np.sin(2 * phi) + c2 * np.sin(4 * phi) - c3 * np.sin(6 * phi)
        )

    def _fwd(self, lam, phi):
        e2, ep2 = self.e2, self.ep2
        sinp, cosp = np.sin(phi), np.cos(phi)
        N = self.a / np.sqrt(1 - e2 * sinp**2)
        T = (sinp / np.where(cosp == 0, 1e-12, cosp)) ** 2
        C = ep2 * cosp**2
        A = (lam - self.lon0) * cosp
        M = self._mdist(phi)
        M0 = self._mdist(self.lat0)
        x = self.k0 * N * (
            A
            + (1 - T + C) * A**3 / 6
            + (5 - 18 * T + T**2 + 72 * C - 58 * ep2) * A**5 / 120
        )
        y = self.k0 * (
            M
            - M0
            + N
            * sinp
            / np.where(cosp == 0, 1e-12, cosp)
            * (
                A**2 / 2
                + (5 - T + 9 * C + 4 * C**2) * A**4 / 24
                + (61 - 58 * T + T**2 + 600 * C - 330 * ep2) * A**6 / 720
            )
        )
        return x, y

    def _inv(self, x, y):
        e2, ep2 = self.e2, self.ep2
        e1 = (1 - math.sqrt(1 - e2)) / (1 + math.sqrt(1 - e2))
        M = self._mdist(self.lat0) + y / self.k0
        mu = M / (self.a * self._mc[0])
        # footpoint latitude (Snyder 3-26)
        phi1 = (
            mu
            + (3 * e1 / 2 - 27 * e1**3 / 32) * np.sin(2 * mu)
            + (21 * e1**2 / 16 - 55 * e1**4 / 32) * np.sin(4 * mu)
            + (151 * e1**3 / 96) * np.sin(6 * mu)
            + (1097 * e1**4 / 512) * np.sin(8 * mu)
        )
        sinp, cosp = np.sin(phi1), np.cos(phi1)
        C1 = ep2 * cosp**2
        T1 = (sinp / np.where(cosp == 0, 1e-12, cosp)) ** 2
        N1 = self.a / np.sqrt(1 - e2 * sinp**2)
        R1 = self.a * (1 - e2) / (1 - e2 * sinp**2) ** 1.5
        D = x / (N1 * self.k0)
        phi = phi1 - (N1 * sinp / np.where(cosp == 0, 1e-12, cosp) / R1) * (
            D**2 / 2
            - (5 + 3 * T1 + 10 * C1 - 4 * C1**2 - 9 * ep2) * D**4 / 24
            + (61 + 90 * T1 + 298 * C1 + 45 * T1**2 - 252 * ep2 - 3 * C1**2)
            * D**6
            / 720
        )
        lam = self.lon0 + (
            D
            - (1 + 2 * T1 + C1) * D**3 / 6
            + (5 - 2 * C1 + 28 * T1 - 3 * C1**2 + 8 * ep2 + 24 * T1**2) * D**5 / 120
        ) / np.where(cosp == 0, 1e-12, cosp)
        return lam, phi


class _SwissObliqueMercator(_Base):
    """+proj=somerc (CH1903/LV03 style; swisstopo reference formulas)."""

    def __init__(self, params):
        super().__init__(params)
        e, e2, phi0 = self.e, self.e2, self.lat0
        self.R = (
            self.k0 * self.a * math.sqrt(1 - e2) / (1 - e2 * math.sin(phi0) ** 2)
        )
        self.alpha = math.sqrt(
            1 + e2 / (1 - e2) * math.cos(phi0) ** 4
        )
        self.b0 = math.asin(math.sin(phi0) / self.alpha)
        self.K = (
            math.log(math.tan(math.pi / 4 + self.b0 / 2))
            - self.alpha * math.log(math.tan(math.pi / 4 + phi0 / 2))
            + self.alpha * e / 2 * math.log(
                (1 + e * math.sin(phi0)) / (1 - e * math.sin(phi0))
            )
        )

    def _fwd(self, lam, phi):
        e = self.e
        S = (
            self.alpha * np.log(np.tan(math.pi / 4 + phi / 2))
            - self.alpha * e / 2 * np.log((1 + e * np.sin(phi)) / (1 - e * np.sin(phi)))
            + self.K
        )
        b = 2 * (np.arctan(np.exp(S)) - math.pi / 4)
        ell = self.alpha * (lam - self.lon0)
        cb0, sb0 = math.cos(self.b0), math.sin(self.b0)
        bbar = np.arcsin(cb0 * np.sin(b) - sb0 * np.cos(b) * np.cos(ell))
        lbar = np.arctan2(np.sin(ell) * np.cos(b), np.cos(ell) * np.cos(b) * cb0 + np.sin(b) * sb0)
        x = self.R * lbar
        y = self.R * np.log(np.tan(math.pi / 4 + bbar / 2))
        return x, y

    def _inv(self, x, y):
        e = self.e
        lbar = x / self.R
        bbar = 2 * (np.arctan(np.exp(y / self.R)) - math.pi / 4)
        cb0, sb0 = math.cos(self.b0), math.sin(self.b0)
        b = np.arcsin(cb0 * np.sin(bbar) + sb0 * np.cos(bbar) * np.cos(lbar))
        ell = np.arctan2(np.sin(lbar) * np.cos(bbar), np.cos(lbar) * np.cos(bbar) * cb0 - np.sin(bbar) * sb0)
        lam = self.lon0 + ell / self.alpha
        # invert the conformal-latitude mapping by fixed point on phi
        S = np.log(np.tan(math.pi / 4 + b / 2))
        phi = b
        for _ in range(8):
            phi = 2 * (
                np.arctan(
                    np.exp(
                        (S - self.K) / self.alpha
                        + e / 2 * np.log((1 + e * np.sin(phi)) / (1 - e * np.sin(phi)))
                    )
                )
                - math.pi / 4
            )
        return lam, phi


class _AzimuthalEquidistant(_Base):
    """Snyder ch. 25 (spherical; proj uses Vincenty-ish ellipsoidal, the
    spherical form is within ~0.1% — used only for plotting/coord grids)."""

    def _fwd(self, lam, phi):
        R = self.a
        sinp0, cosp0 = math.sin(self.lat0), math.cos(self.lat0)
        cosc = sinp0 * np.sin(phi) + cosp0 * np.cos(phi) * np.cos(lam - self.lon0)
        c = np.arccos(np.clip(cosc, -1, 1))
        k = np.where(c == 0, 1.0, c / np.where(np.sin(c) == 0, 1e-12, np.sin(c)))
        x = R * k * np.cos(phi) * np.sin(lam - self.lon0)
        y = R * k * (cosp0 * np.sin(phi) - sinp0 * np.cos(phi) * np.cos(lam - self.lon0))
        return x, y

    def _inv(self, x, y):
        R = self.a
        rho = np.hypot(x, y)
        c = rho / R
        sinp0, cosp0 = math.sin(self.lat0), math.cos(self.lat0)
        sinc, cosc = np.sin(c), np.cos(c)
        safe_rho = np.where(rho == 0, 1e-12, rho)
        phi = np.arcsin(np.clip(cosc * sinp0 + y * sinc * cosp0 / safe_rho, -1, 1))
        lam = self.lon0 + np.arctan2(
            x * sinc, safe_rho * cosp0 * cosc - y * sinp0 * sinc
        )
        return np.where(rho == 0, self.lon0, lam), np.where(rho == 0, self.lat0, phi)


class _LambertAzimuthalEqualArea(_Base):
    """Snyder ch. 24 (ellipsoidal oblique, e.g. the OPERA European grid)."""

    def __init__(self, params):
        super().__init__(params)
        e, e2 = self.e, self.e2
        self.qp = _q(math.pi / 2, e, e2)
        q0 = _q(self.lat0, e, e2)
        self.beta0 = math.asin(min(1.0, max(-1.0, q0 / self.qp)))
        self.Rq = self.a * math.sqrt(self.qp / 2)
        self.D = (
            self.a * _m(self.lat0, e2) / (self.Rq * math.cos(self.beta0))
            if abs(self.lat0) < math.pi / 2 - 1e-9
            else 1.0
        )

    def _fwd(self, lam, phi):
        beta = np.arcsin(np.clip(_q(phi, self.e, self.e2) / self.qp, -1, 1))
        sb0, cb0 = math.sin(self.beta0), math.cos(self.beta0)
        dl = lam - self.lon0
        B = self.Rq * np.sqrt(
            2 / (1 + sb0 * np.sin(beta) + cb0 * np.cos(beta) * np.cos(dl))
        )
        x = B * self.D * np.cos(beta) * np.sin(dl)
        y = (B / self.D) * (cb0 * np.sin(beta) - sb0 * np.cos(beta) * np.cos(dl))
        return x, y

    def _inv(self, x, y):
        sb0, cb0 = math.sin(self.beta0), math.cos(self.beta0)
        rho = np.hypot(x / self.D, self.D * y)
        ce = 2 * np.arcsin(np.clip(rho / (2 * self.Rq), -1, 1))
        sc, cc = np.sin(ce), np.cos(ce)
        safe_rho = np.where(rho == 0, 1e-12, rho)
        q = self.qp * (cc * sb0 + self.D * y * sc * cb0 / safe_rho)
        phi = _phi_from_q(q, self.e, self.e2)
        lam = self.lon0 + np.arctan2(
            x * sc, self.D * safe_rho * cb0 * cc - self.D**2 * y * sb0 * sc
        )
        return np.where(rho == 0, self.lon0, lam), np.where(
            rho == 0, self.lat0, phi
        )


_PROJECTIONS = {
    "longlat": _LongLat,
    "latlong": _LongLat,
    "lonlat": _LongLat,
    "merc": _Mercator,
    "stere": _PolarStereographic,
    "aea": _Albers,
    "tmerc": _TransverseMercator,
    "utm": _TransverseMercator,
    "somerc": _SwissObliqueMercator,
    "aeqd": _AzimuthalEquidistant,
    "laea": _LambertAzimuthalEqualArea,
}


class Proj:
    """pyproj.Proj-compatible facade: ``Proj(s)(lon, lat)`` -> (x, y);
    ``Proj(s)(x, y, inverse=True)`` -> (lon, lat)."""

    def __init__(self, proj4str):
        self.srs = str(proj4str)
        self.params = parse_proj4(proj4str)
        name = self.params.get("proj")
        if name not in _PROJECTIONS:
            raise MissingOptionalDependency(
                f"projection '{name}' is not supported by the built-in "
                "transformer and pyproj is not available"
            )
        self._impl = _PROJECTIONS[name](self.params)

    def __call__(self, x, y, inverse=False):
        if inverse:
            return self._impl.inverse(x, y)
        lon, lat = x, y
        return self._impl.forward(lon, lat)


def lonlat_grid(proj4str, x_coords, y_coords):
    """(lon, lat) 2-D grids for projected 1-D coordinate vectors; None on
    unsupported projections (callers then omit lon/lat output)."""
    try:
        proj = Proj(proj4str)
    except MissingOptionalDependency:
        return None
    x2d, y2d = np.meshgrid(np.asarray(x_coords), np.asarray(y_coords))
    lon, lat = proj(x2d, y2d, inverse=True)
    return np.asarray(lon), np.asarray(lat)
