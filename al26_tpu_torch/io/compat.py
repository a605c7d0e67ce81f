"""Reference-compatible checkpoint object model (the port's copy of
al26_tpu/io/compat.py, which it does not import).

The reference pickles a `State{cluster: amuse Particles, converter,
metadata}` per checkpoint (al26_nbody.py:281-293) and its post-processing
reads back ~30 unit-tagged per-star attributes (`cluster.mass_26al_local`,
`cluster.tau_disk`, `metadata.args.n`, ...; plotting/postprocess.py:74-98,
plot_slr_statistics.py:40-53). This module provides AMUSE-free equivalents:

  * `Particles` — a SoA table whose attribute access returns unit-tagged
    `Quantity` arrays (`.value_in(msol)` etc.), supporting len/iter/index
    exactly as the consumers use it;
  * `Metadata` / `Args` / `Converter` / `State` — matching field names;
  * `cluster_to_particles` / `particles_to_cluster` — lossless mapping
    between the device `Cluster` pytree and the reference attribute names
    (isotope/channel axes <-> `mass_{26al,60fe}_{local,global,sne,agb}`);
  * the tolerant unpickler — loads state pickles written by the REFERENCE
    (which embed AMUSE classes) without AMUSE installed, by stubbing
    unknown classes and extracting the numeric payloads;
  * `dumps` / `loads` — the port's files ARE the JAX package's files: the
    pickler writes the classes above under the JAX package's global names
    (`al26_tpu.io.compat.State`, ..., `al26_tpu.units.Quantity` / `Unit`,
    the names the reference post-processing environment resolves), without
    importing that package; the unpickler maps those names, and the port's
    own, back to the port's classes, and falls back to the tolerant stubs.
"""
from __future__ import annotations

import io as _io
import pickle
from datetime import datetime

import numpy as np

from ..state import CHANNEL_NAMES, ISO_NAMES, N_CH, N_ISO
from ..units import Quantity, Unit, au, msol, myr, pc, pcmyr

# attribute name -> Unit for the reference's per-star columns
_UNIT_BY_ATTR = {
    "mass": msol, "radius": au,
    "x": pc, "y": pc, "z": pc,
    "vx": pcmyr, "vy": pcmyr, "vz": pcmyr,
    "m_disk_gas": msol, "m_disk_dust": msol,
    "r_disk": pc, "tau_disk": myr,
    "mass_27al": msol, "mass_56fe": msol,
    "total_wind_loss": msol,
    "wind_yield_26al": msol, "wind_yield_60fe": msol,
    "sn_yield_26al": msol, "sn_yield_60fe": msol,
    "initial_mass": msol, "mdot": msol / myr, "age": myr,
}
for _iso in ISO_NAMES:
    for _ch in CHANNEL_NAMES:
        _UNIT_BY_ATTR[f"mass_{_iso}_{_ch}"] = msol
        _UNIT_BY_ATTR[f"mass_{_iso}_{_ch}_final"] = msol
    _UNIT_BY_ATTR[f"mass_{_iso}_agb_raw"] = msol

class Star:
    """One row of a Particles table (attribute access per star, as used by
    postprocess.py:90-106)."""

    __slots__ = ("_p", "_i")

    def __init__(self, particles: "Particles", i: int):
        object.__setattr__(self, "_p", particles)
        object.__setattr__(self, "_i", i)

    def __getattr__(self, name):
        col = getattr(self._p, name)
        return col[self._i]


class Particles:
    """AMUSE-free particle table: dict of numpy columns, attribute access
    returns unit-tagged Quantities (raw arrays for dimensionless columns)."""

    def __init__(self, columns: dict[str, np.ndarray]):
        self.__dict__["_columns"] = dict(columns)

    def __getattr__(self, name):
        cols = self.__dict__["_columns"]
        if name not in cols:
            raise AttributeError(name)
        a = cols[name]
        unit = _UNIT_BY_ATTR.get(name)
        if unit is None:
            return a
        return Quantity(a, unit)

    def __setattr__(self, name, value):
        if isinstance(value, Quantity):
            unit = _UNIT_BY_ATTR.get(name)
            self.__dict__["_columns"][name] = np.asarray(
                value.value_in(unit) if unit else value.value
            )
        else:
            self.__dict__["_columns"][name] = np.asarray(value)

    def __len__(self):
        return len(next(iter(self.__dict__["_columns"].values())))

    def __iter__(self):
        for i in range(len(self)):
            yield Star(self, i)

    def __getitem__(self, i):
        if isinstance(i, (int, np.integer)):
            i = int(i)
            n = len(self)
            if i < 0:
                i += n
            if not 0 <= i < n:
                # raise rather than wrap: a silent modulo returns a WRONG
                # star with valid-looking data on an off-by-one
                raise IndexError(f"star index {i} out of range for {n}")
            return Star(self, i)
        return Particles({k: v[i] for k, v in self.__dict__["_columns"].items()})

    def columns(self) -> dict[str, np.ndarray]:
        return self.__dict__["_columns"]

    # pickle support
    def __getstate__(self):
        return self.__dict__["_columns"]

    def __setstate__(self, columns):
        self.__dict__["_columns"] = columns


class Args:
    """Pickle-friendly argparse.Namespace stand-in: the reference stores its
    parsed args inside Metadata (al26_nbody.py:91) and postprocess reads
    `metadata.args.n` / `.rc` (postprocess.py:77-78)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def __repr__(self):
        return f"Args({self.__dict__!r})"


class Converter:
    """Unit-converter stand-in recording the nbody scaling the reference
    builds with nbody_to_si(Rc, Mcluster) (al26_nbody.py:1516)."""

    def __init__(self, rc_pc: float, mass_msun: float):
        self.rc_pc = rc_pc
        self.mass_msun = mass_msun


class Metadata:
    """Matches the reference Metadata fields (al26_nbody.py:83-123)."""

    def __init__(self, args: Args, t_f_myr: float, filename: str = ""):
        self.sim_start = datetime.now()
        self.sim_start_str = self.sim_start.strftime("%d/%m/%Y %H:%M:%S")
        self.args = args
        self.model = getattr(args, "model", "plummer")
        self.nstars = getattr(args, "n", None)
        self.cluster_radius = getattr(args, "rc", None)
        if filename:
            self.filename = filename
        else:
            self.filename = "sim-" + self.sim_start.strftime("%Y-%m-%d-%H-%M-%S")
        self.time = Quantity(0.0, myr)
        self.t_f = Quantity(t_f_myr, myr)
        self.completion = 0.0
        self.most_recent_checkpoint = 0
        self.update_access_time()

    def update(self, current_time_myr: float, increment_checkpoint: bool = True):
        if increment_checkpoint:
            self.most_recent_checkpoint += 1
        self.time = Quantity(current_time_myr, myr)
        self.completion = current_time_myr / self.t_f.value_in(myr)
        self.update_access_time()

    def update_access_time(self):
        self.sim_last = datetime.now()
        self.sim_last_str = self.sim_last.strftime("%d/%m/%Y %H:%M:%S")


class State:
    """Checkpoint bundle (al26_nbody.py:281-293)."""

    def __init__(self, cluster: Particles, converter, metadata: Metadata):
        self.cluster = cluster
        self.converter = converter
        self.metadata = metadata


# ---------------------------------------------------------------------------
# Cluster pytree <-> reference attribute layout
# ---------------------------------------------------------------------------
def cluster_to_particles(c: "Cluster | dict") -> Particles:
    """Map the Cluster (or its numpy dict, state.cluster_to_numpy) to
    reference-named columns (al26_nbody.py:1540-1604 attribute set)."""
    from ..state import cluster_to_numpy

    d = cluster_to_numpy(c) if not isinstance(c, dict) else c
    n = len(d["mass"])
    cols: dict[str, np.ndarray] = {
        "key": np.arange(1, n + 1, dtype=np.int64),
        "mass": d["mass"],
        "initial_mass": d["m0"],
        "radius": np.zeros(n),
        "x": d["pos"][:, 0], "y": d["pos"][:, 1], "z": d["pos"][:, 2],
        "vx": d["vel"][:, 0], "vy": d["vel"][:, 1], "vz": d["vel"][:, 2],
        "mdot": d["mdot"],
        "kicked": d["kicked"], "disk_alive": d["disk_alive"],
        "m_disk_gas": d["m_disk_gas"], "m_disk_dust": d["m_disk_dust"],
        "r_disk": d["r_disk"], "tau_disk": d["tau_disk"],
        "mass_27al": d["mass_27al"], "mass_56fe": d["mass_56fe"],
        "total_wind_loss": d["total_wind_loss"],
        "is_interloper": d["is_interloper"],
    }
    for s, iso in enumerate(ISO_NAMES):
        for ci, ch in enumerate(CHANNEL_NAMES):
            cols[f"mass_{iso}_{ch}"] = d["slr"][:, s, ci]
            cols[f"mass_{iso}_{ch}_final"] = d["slr_final"][:, s, ci]
        cols[f"mass_{iso}_agb_raw"] = d["agb_raw"][:, s]
        cols[f"wind_ratio_{iso}"] = d["wind_ratio"][:, s]
        cols[f"sn_yield_{iso}"] = d["sn_yield"][:, s]
    return Particles(cols)


def particles_to_cluster(p: Particles, dtype=None, *, device):
    """Inverse mapping: rebuild the Cluster on `device` from a Particles
    table (used on checkpoint resume); `dtype` None keeps float64."""
    from ..state import cluster_from_numpy

    cols = p.columns()
    n = len(p)
    get = lambda k, default=0.0: np.asarray(
        cols.get(k, np.full(n, default))
    )
    slr = np.zeros((n, N_ISO, N_CH))
    slr_final = np.zeros((n, N_ISO, N_CH))
    agb_raw = np.zeros((n, N_ISO))
    wind_ratio = np.zeros((n, N_ISO))
    sn_yield = np.zeros((n, N_ISO))
    for s, iso in enumerate(ISO_NAMES):
        for ci, ch in enumerate(CHANNEL_NAMES):
            slr[:, s, ci] = get(f"mass_{iso}_{ch}")
            slr_final[:, s, ci] = get(f"mass_{iso}_{ch}_final")
        agb_raw[:, s] = get(f"mass_{iso}_agb_raw")
        wind_ratio[:, s] = get(f"wind_ratio_{iso}")
        sn_yield[:, s] = get(f"sn_yield_{iso}")
    d = {
        "pos": np.stack([get("x"), get("y"), get("z")], -1),
        "vel": np.stack([get("vx"), get("vy"), get("vz")], -1),
        "mass": get("mass"),
        "m0": get("initial_mass") if "initial_mass" in cols else get("mass"),
        "mdot": get("mdot"),
        "kicked": np.asarray(cols.get("kicked", np.zeros(n, bool)), bool),
        "r_disk": get("r_disk"), "tau_disk": get("tau_disk"),
        "disk_alive": np.asarray(cols.get("disk_alive", np.zeros(n, bool)), bool),
        "m_disk_gas": get("m_disk_gas"), "m_disk_dust": get("m_disk_dust"),
        "mass_27al": get("mass_27al"), "mass_56fe": get("mass_56fe"),
        "slr": slr, "slr_final": slr_final, "agb_raw": agb_raw,
        "wind_ratio": wind_ratio, "sn_yield": sn_yield,
        "total_wind_loss": get("total_wind_loss"),
        "is_interloper": np.asarray(
            cols.get("is_interloper", np.zeros(n, bool)), bool
        ),
    }
    kw = {} if dtype is None else {"dtype": dtype}
    return cluster_from_numpy(d, device=device, **kw)


# ---------------------------------------------------------------------------
# Tolerant unpickling of REFERENCE-written state files (no AMUSE needed)
# ---------------------------------------------------------------------------
class _Stub:
    """Generic stand-in for an unimportable class: records constructor args
    and state so the payload can be mined afterwards."""

    _stub_class = "?"

    def __init__(self, *args, **kw):
        self._stub_args = args
        self._stub_kw = kw

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        elif (isinstance(state, tuple) and len(state) == 2
              and all(s is None or isinstance(s, dict) for s in state)):
            # protocol-2 state of a __slots__ class: (dict_state, slots_state)
            for s in state:
                if s:
                    self.__dict__.update(s)
        else:
            self._stub_state = state


def _make_stub(module: str, name: str):
    return type(name, (_Stub,), {"_stub_class": f"{module}.{name}"})


# the global names the JAX package's files carry for these classes
_JAX_NAMES = {
    State: ("al26_tpu.io.compat", "State"),
    Particles: ("al26_tpu.io.compat", "Particles"),
    Metadata: ("al26_tpu.io.compat", "Metadata"),
    Args: ("al26_tpu.io.compat", "Args"),
    Converter: ("al26_tpu.io.compat", "Converter"),
    Quantity: ("al26_tpu.units", "Quantity"),
    Unit: ("al26_tpu.units", "Unit"),
}


class _JaxNamePickler(pickle._Pickler):
    """Pickles the classes of _JAX_NAMES under the JAX package's global
    names. Python's pickler would import a class's module to check its
    identity (save_global); this one writes the name itself, so the JAX
    package is never imported."""

    def save_global(self, obj, name=None):
        target = _JAX_NAMES.get(obj)
        if target is None:
            return super().save_global(obj, name)
        module, qualname = target
        if self.proto >= 4:
            self.save(module)
            self.save(qualname)
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL + f"{module}\n{qualname}\n".encode())
        self.memoize(obj)


def dumps(obj) -> bytes:
    """Pickle `obj` (a State) as the JAX package pickles it."""
    buf = _io.BytesIO()
    _JaxNamePickler(buf, pickle.DEFAULT_PROTOCOL).dump(obj)
    return buf.getvalue()


class _TolerantUnpickler(pickle.Unpickler):
    """Resolve the JAX package's class paths and ours to the port's
    classes, reference/AMUSE class paths to local shims or stubs. No
    module of the JAX package is ever imported."""

    _CLASSES = {cls.__name__: cls for cls in _JAX_NAMES}
    _REDIRECT = {
        ("al26_nbody", "State"): State,
        ("al26_nbody", "Metadata"): Metadata,
        ("al26_nbody", "Args"): Args,
        ("argparse", "Namespace"): Args,
    }

    def find_class(self, module, name):
        if module in ("al26_tpu.io.compat", "al26_tpu_torch.io.compat",
                      "al26_tpu.units", "al26_tpu_torch.units"):
            if name in self._CLASSES:
                return self._CLASSES[name]
        key = (module.split(".")[-1], name)
        if key in self._REDIRECT:
            return self._REDIRECT[key]
        if module == "al26_tpu" or module.startswith("al26_tpu."):
            return _make_stub(module, name)
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return _make_stub(module, name)


def loads(data: bytes):
    """Unpickle a state file's payload — the port's, the JAX package's or
    the reference's — into the port's classes (normalize_loaded_state
    rebuilds an AMUSE payload)."""
    state = _TolerantUnpickler(_io.BytesIO(data)).load()
    return normalize_loaded_state(state)


# ---------------------------------------------------------------------------
# Mining the AMUSE object graph out of the stubs
#
# A reference-written state file embeds AMUSE classes (al26_nbody.py:281-293);
# the tolerant unpickler turns each into a `_Stub` carrying the original
# instance payload. The functions below rebuild working objects from those
# payloads, following AMUSE's documented internal layout:
#
#   amuse.datamodel.particles.Particles
#     ._private.attribute_storage          (amuse/datamodel/particles.py)
#   amuse.datamodel.memory.InMemoryAttributeStorage
#     .mapping_from_attribute_to_quantities: {name: attribute}
#     .particle_keys: ndarray              (amuse/datamodel/memory.py)
#   InMemoryVectorQuantityAttribute.quantity -> VectorQuantity
#   InMemoryUnitlessAttribute.values     -> ndarray
#   amuse.units.quantities.{Scalar,Vector}Quantity: .number, .unit
#   amuse.units.core unit algebra:
#     base_unit(.quantity in 'mass'|'length'|'time'), named_unit(.local_unit),
#     factor_unit(.local_factor, .local_unit), mul_unit/div_unit
#     (.left_hand, .right_hand), pow_unit(.local_unit, .power), none_unit
#
# Attribute spellings vary slightly across AMUSE versions, so every lookup
# tries the known alternatives and the walk is duck-typed on stub payloads.
# ---------------------------------------------------------------------------
def _stub_attrs(obj) -> dict:
    """All payload attributes recorded on a stub (or a real object)."""
    if obj is None:
        return {}
    d = dict(getattr(obj, "__dict__", {}) or {})
    d.pop("_stub_args", None)
    kw = d.pop("_stub_kw", None)
    if kw:
        d.update(kw)
    st = d.pop("_stub_state", None)
    if isinstance(st, dict):
        d.update(st)
    return d


def _first(d: dict, *names):
    for n in names:
        if n in d:
            return d[n]
    return None


def unit_from_stub(u) -> Unit:
    """Evaluate a (stubbed) AMUSE unit expression tree into our `Unit`
    (SI factor + (mass, length, time) exponent signature)."""
    if isinstance(u, Unit):
        return u
    cls = getattr(u, "_stub_class", type(u).__name__)
    d = _stub_attrs(u)
    # base_unit: dimension named by .quantity
    if "system" in d or cls.endswith("base_unit"):
        q = str(_first(d, "quantity") or "")
        sig = {"mass": (1, 0, 0), "length": (0, 1, 0),
               "time": (0, 0, 1)}.get(q)
        if sig is None:
            raise ValueError(f"unsupported base unit dimension: {q!r}")
        return Unit(str(_first(d, "symbol", "name") or q), 1.0, sig)
    # factor_unit: factor * unit
    factor = _first(d, "local_factor", "factor")
    if factor is not None:
        inner = unit_from_stub(_first(d, "local_unit", "unit"))
        return Unit(inner.name, float(factor) * inner.si_factor, inner.sig)
    # pow_unit
    power = _first(d, "power", "exponent")
    if power is not None:
        inner = unit_from_stub(_first(d, "local_unit", "unit"))
        return inner ** int(power)
    # mul/div
    left = _first(d, "left_hand", "lhs")
    right = _first(d, "right_hand", "rhs")
    if left is not None and right is not None:
        lu, ru = unit_from_stub(left), unit_from_stub(right)
        return lu / ru if ("div" in cls) else lu * ru
    # named_unit: alias for .local_unit
    inner = _first(d, "local_unit", "unit")
    if inner is not None:
        base = unit_from_stub(inner)
        return Unit(str(_first(d, "symbol", "name") or base.name),
                    base.si_factor, base.sig)
    if "none_unit" in cls or "zero_unit" in cls or not d:
        return Unit("none", 1.0, (0, 0, 0))
    raise ValueError(f"cannot evaluate AMUSE unit stub {cls}: {sorted(d)}")


def quantity_from_stub(q) -> Quantity:
    """(stubbed) amuse ScalarQuantity/VectorQuantity -> our Quantity."""
    if isinstance(q, Quantity):
        return q
    d = _stub_attrs(q)
    number = _first(d, "number", "_number")
    if number is None:
        raise ValueError(
            f"stub {getattr(q, '_stub_class', '?')} has no .number: "
            f"{sorted(d)}"
        )
    return Quantity(np.asarray(number) if np.ndim(number) else number,
                    unit_from_stub(d.get("unit")))


def particles_from_amuse_stub(p) -> Particles:
    """Rebuild a `Particles` table from a stubbed AMUSE Particles graph.

    Values are converted into this framework's canonical column units
    (`_UNIT_BY_ATTR`) regardless of the units the reference stored them in
    (e.g. SI metres from the nbody converter vs parsec)."""
    private = _first(_stub_attrs(p), "_private")
    storage = _first(_stub_attrs(private), "attribute_storage", "storage")
    if storage is None:
        raise ValueError(
            "not an AMUSE Particles payload (no _private.attribute_storage)"
        )
    st = _stub_attrs(storage)
    mapping = _first(st, "mapping_from_attribute_to_quantities",
                     "mapping_from_attribute_to_values")
    if not isinstance(mapping, dict):
        # fall back: the only dict-of-stubs payload in the storage
        dicts = [v for v in st.values() if isinstance(v, dict) and v]
        mapping = dicts[0] if dicts else None
    if not isinstance(mapping, dict):
        raise ValueError("AMUSE attribute storage has no attribute mapping")
    cols: dict[str, np.ndarray] = {}
    keys = _first(st, "particle_keys", "keys")
    if keys is not None:
        cols["key"] = np.asarray(keys)
    for name, attr in mapping.items():
        a = _stub_attrs(attr)
        qstub = _first(a, "quantity")
        if qstub is not None:
            q = quantity_from_stub(qstub)
            target = _UNIT_BY_ATTR.get(name)
            if target is not None:
                cols[name] = np.asarray(q.value_in(target))
            else:
                # dimensionless, or a united attribute we do not track:
                # keep SI magnitudes
                cols[name] = np.asarray(q.value) * q.unit.si_factor
        else:
            values = _first(a, "values", "_values")
            if values is None:
                continue
            cols[name] = np.asarray(values)
    if not cols:
        raise ValueError("AMUSE attribute mapping yielded no columns")
    return Particles(cols)


def normalize_loaded_state(state):
    """Post-process a tolerant-loaded State: rebuild the cluster table from
    an AMUSE stub graph and re-tag the metadata's unit-carrying fields so
    downstream code (`metadata.time.value_in(myr)`, postprocess) works on
    reference-written files exactly as on ours."""
    cluster = getattr(state, "cluster", None)
    if isinstance(cluster, _Stub):
        state.cluster = particles_from_amuse_stub(cluster)
    md = getattr(state, "metadata", None)
    if md is not None:
        for field in ("time", "t_f"):
            v = getattr(md, field, None)
            if isinstance(v, _Stub):
                setattr(md, field, quantity_from_stub(v))
    return state
