"""INI-config-driven command line interface of the port.

Counterpart of :mod:`heracles_tpu.cli`: the ``heracles-tpu-torch``
command (also ``python -m heracles_tpu_torch``) provides the four
pipeline stages ``maps``, ``alms``, ``spectra``, ``mixmats``, driven by
the same INI schema, and builds the port's objects:

* a ``defaults`` section applied everywhere (``mapper = healpix``);
* namespaced subsections ``fields:NAME``, ``catalogs:NAME``,
  ``spectra:NAME``;
* converters ``getlist``/``getdict``/``getpath``/``getfilter`` (filters
  use ``...`` wildcards matching the tuple-key system);
* bins of the form ``<size> <spacing> [<weights>]`` with linear/log/
  sqrt/log1p spacings and ``2l+1`` / ``l(l+1)`` weights.

State crosses stages via FITS files, so pipelines are restartable and
trivially sharded by selection/stage across jobs.  ``--device`` (default
``cuda``) is the device of every mapper, of the visibility transforms and
of the mixing matrices; ``--device cpu`` runs the plain versions of the
kernels.  HEALPix maps always stay on their device (``device_maps =
false`` raises).
"""

from __future__ import annotations

import argparse
import configparser
import logging
import os
from collections.abc import Mapping
from typing import Any

import numpy as np

# field "type" option -> dotted implementation path
FIELD_TYPES = {
    "positions": "heracles_tpu_torch.fields:Positions",
    "shears": "heracles_tpu_torch.fields:Shears",
    "visibility": "heracles_tpu_torch.fields:Visibility",
    "weights": "heracles_tpu_torch.fields:Weights",
}

_MISSING = object()


def getlist(value):
    """Multi-line option value -> list of stripped non-empty lines."""
    return [line for line in (s.strip() for s in value.splitlines()) if line]


def getdict(value):
    """Multi-line 'KEY = VALUE' option value -> dict."""
    out = {}
    for line in getlist(value):
        if "=" not in line:
            raise ValueError(
                f"expected 'KEY = VALUE', got {line!r}"
            )
        key, val = line.split("=", 1)
        out[key.strip()] = val.strip()
    return out


def getchoice(value, choices):
    """Look *value* up in *choices*, with a helpful error."""
    if value not in choices:
        allowed = ", ".join(repr(c) for c in choices)
        raise ValueError(f"{value!r} is not one of: {allowed}")
    return choices[value]


def getpath(value):
    """Path with user/env expansion."""
    return os.path.expanduser(os.path.expandvars(value))


def _filter_part(part):
    """One element of a tuple-key pattern: int, '...' wildcard, or str."""
    if part == "...":
        return ...
    try:
        return int(part)
    except ValueError:
        return part


def getfilter(value):
    """Multi-line comma-separated include/exclude patterns ('...' wild)."""
    return [
        tuple(_filter_part(p.strip()) for p in row.split(","))
        for row in getlist(value)
    ]


# configparser wiring for the INI schema: '=' delimiters, '#' comments,
# a 'defaults' section feeding every other section, no interpolation
_PARSER_OPTIONS = dict(
    defaults={"mapper": "healpix"},
    dict_type=dict,
    allow_no_value=False,
    delimiters=("=",),
    comment_prefixes=("#",),
    inline_comment_prefixes=("#",),
    strict=True,
    empty_lines_in_values=False,
    default_section="defaults",
    interpolation=None,
    converters={
        "list": getlist,
        "dict": getdict,
        "path": getpath,
        "filter": getfilter,
    },
)


class ConfigParser(configparser.ConfigParser):
    """The pipeline's config dialect (see module docstring)."""

    def __init__(self):
        super().__init__(**_PARSER_OPTIONS)

    def getchoice(self, section, option, choices, *, fallback=_MISSING):
        """Option value constrained to the keys of *choices*."""
        raw = self.get(section, option, fallback=None)
        if raw is None:
            if fallback is _MISSING:
                raise configparser.NoOptionError(option, section)
            return fallback
        return getchoice(raw, choices)

    def subsections(self, group):
        """Mapping of NAME -> section for all ``group:NAME`` sections."""
        out = {}
        for section in super().sections():
            head, sep, tail = section.partition(":")
            if sep and head == group:
                out[tail.strip()] = section
        return out


# -- factories: config sections -> pipeline objects -------------------------


def _healpix_mapper(config, section, device):
    from .mappers import HealpixMapper

    # maps stay on the mapper's device; an explicit false raises there
    device_maps = config.getboolean(section, "device_maps", fallback=True)
    # dd accepts the INI booleans plus the "comp" mode name
    dd_raw = config.get(section, "dd", fallback=None)
    if dd_raw is None:
        dd = None
    elif dd_raw.strip().lower() in ("comp", "accum"):
        dd = "comp"
    else:
        dd = config.getboolean(section, "dd")
    return HealpixMapper(
        config.getint(section, "nside"),
        config.getint(section, "lmax", fallback=None),
        deconvolve=config.getboolean(section, "deconvolve", fallback=None),
        device_maps=device_maps,
        dd=dd,
        iterations=config.getint(section, "iterations", fallback=0),
        device=device,
    )


def _discrete_mapper(config, section, device):
    from .mappers import DiscreteMapper

    return DiscreteMapper(
        config.getint(section, "lmax", fallback=None),
        epsilon=config.getfloat(section, "epsilon", fallback=None),
        method=config.get(section, "method", fallback="auto"),
        device=device,
    )


_MAPPER_FACTORIES = {
    "none": lambda config, section, device: None,
    "healpix": _healpix_mapper,
    "discrete": _discrete_mapper,
}


def mapper_from_config(config, section, device="cuda"):
    """Mapper instance from a config section (none/healpix/discrete), on
    ``device``."""
    factory = config.getchoice(section, "mapper", _MAPPER_FACTORIES)
    return factory(config, section, device)


def field_from_config(config, section, device="cuda"):
    """Field instance from a config section, its mapper on ``device``."""
    from pkgutil import resolve_name

    dotted = config.getchoice(section, "type", FIELD_TYPES)
    try:
        cls = resolve_name(dotted)
    except (ValueError, ImportError, AttributeError) as exc:
        raise RuntimeError(
            f"field type {config.get(section, 'type')!r} "
            f"(-> {dotted!r}) failed to import: {exc!s}"
        ) from None
    return cls(
        mapper_from_config(config, section, device),
        *config.getlist(section, "columns", fallback=()),
        mask=config.get(section, "mask", fallback=None),
    )


def fields_from_config(config, device="cuda"):
    """All fields from the ``fields:NAME`` sections, mappers on ``device``."""
    return {
        name: field_from_config(config, section, device)
        for name, section in config.subsections("fields").items()
    }


def _visibility_map(path, transform, lmax, device):
    """Load one visibility map (optionally to alms) or raise ValueError."""
    from .io import read_vmap

    try:
        return read_vmap(getpath(path), transform=transform, lmax=lmax,
                         device=device)
    except (TypeError, ValueError, OSError) as exc:
        raise ValueError(
            f"could not load visibility map {path!r}: {exc!s}"
        ) from None


def catalog_from_config(config, section, label=None, *, out=None,
                        device="cuda"):
    """Catalogue (views) from a config section.

    Supports per-catalogue or per-selection visibility maps, optional
    harmonic transform of visibilities (on ``device``), and numbered
    selections producing :class:`~heracles_tpu_torch.catalog.CatalogView`
    instances.
    """
    from .catalog import FitsCatalog

    vis = config.get(section, "visibility", fallback=None)
    vis_transform = config.getboolean(
        section, "visibility-transform", fallback=False
    )
    vis_lmax = config.getint(section, "visibility-lmax", fallback=None)
    if vis and "\n" in vis:
        # one visibility per selection number
        vis = config.getdict(section, "visibility")

    base = FitsCatalog(config.getpath(section, "source"))
    base.label = label
    if isinstance(vis, str):
        base.visibility = _visibility_map(vis, vis_transform, vis_lmax,
                                          device)

    if out is None:
        out = {}
    mine = set()
    for key, where in config.getdict(section, "selections").items():
        num = int(key)
        if num in out:
            raise ValueError(f"selection {num} defined more than once")
        out[num] = base.where(where) if where else base
        mine.add(num)

    if isinstance(vis, Mapping):
        # per-selection maps may only target selections from this section
        for key, path in vis.items():
            num = int(key)
            if num not in mine:
                raise ValueError(
                    f"visibility given for unknown selection '{num}'"
                )
            out[num].visibility = _visibility_map(
                path, vis_transform, vis_lmax, device
            )
    return out


def catalogs_from_config(config, device="cuda"):
    """All catalogues from the ``catalogs:NAME`` sections."""
    catalogs = {}
    for label, section in config.subsections("catalogs").items():
        catalog_from_config(config, section, label, out=catalogs,
                            device=device)
    return catalogs


# bin spacing name -> (forward, inverse) axis maps
_SPACINGS = {
    "linear": (lambda x: x, lambda x: x),
    "log": (np.log10, lambda x: 10**x),
    "sqrt": (np.sqrt, np.square),
    "log1p": (np.log1p, np.expm1),
}
_BIN_WEIGHTS = (None, "2l+1", "l(l+1)")


def bins_from_config(config, section):
    """Angular bin edges + weights from '<size> <spacing> [<weights>]'."""
    spec = config.get(section, "bins", fallback="none")
    if spec == "none":
        return None, None
    parts = spec.split()
    if len(parts) not in (2, 3):
        raise ValueError(
            f"[{section}] bins: want '<size> <spacing> [<weights>]', "
            f"got {spec!r}"
        )
    n = int(parts[0])
    spacing = parts[1]
    weight = parts[2] if len(parts) == 3 else None
    if n < 2:
        raise ValueError(f"[{section}] bins: need at least 2 bins, got {n}")
    if spacing not in _SPACINGS:
        raise ValueError(f"[{section}] bins: unknown spacing {spacing!r}")
    if weight not in _BIN_WEIGHTS:
        raise ValueError(f"[{section}] bins: unknown weights {weight!r}")
    lmin = config.getint(section, "lmin", fallback=1)
    lmax = config.getint(section, "lmax")
    fwd, inv = _SPACINGS[spacing]
    edges = inv(np.linspace(fwd(lmin), fwd(lmax + 1), n + 1))
    # the transform pair can round the end points; pin them exactly
    edges[0], edges[-1] = lmin, lmax + 1
    return edges, weight


# spectra-section options and how to read each
_SPECTRUM_OPTIONS = {
    "lmax": lambda opts: opts.getint("lmax"),
    "l2max": lambda opts: opts.getint("l2max"),
    "l3max": lambda opts: opts.getint("l3max"),
    "include": lambda opts: opts.getfilter("include"),
    "exclude": lambda opts: opts.getfilter("exclude"),
    "debias": lambda opts: opts.getboolean("debias"),
}


def spectrum_from_config(config, section):
    """kwargs dict for angular_power_spectra / mixing_matrices."""
    options = config[section]
    info: dict[str, Any] = {
        name: read(options)
        for name, read in _SPECTRUM_OPTIONS.items()
        if name in options
    }
    if "bins" in options:
        info["bins"] = bins_from_config(config, section)
    return info


def spectra_from_config(config):
    """(label, kwargs) pairs for every ``spectra:NAME`` section."""
    pairs = [
        (label, spectrum_from_config(config, section))
        for label, section in config.subsections("spectra").items()
    ]
    return pairs or [(None, {})]


def configloader(path):
    """Load one or more INI files into a ConfigParser."""
    if isinstance(path, (str, os.PathLike)):
        path = (path,)
    config = ConfigParser()
    for p in path:
        with open(p) as fp:
            config.read_file(fp)
    return config


DEFAULT_LOADER = configloader


# -- pipeline stages --------------------------------------------------------


def _progress_obj(progress):
    if not progress:
        return None
    try:
        from .rich_progress import RichProgress

        return RichProgress()
    except Exception:
        return None


def _label_str(label):
    return repr(label) if label is not None else "all"


def map_all_selections(fields, config, logger, progress, device="cuda"):
    """Yield map dicts per catalogue selection (on-the-fly, low memory)."""
    from .mapping import map_catalogs

    catalogs = catalogs_from_config(config, device)
    logger.info("mapping fields: %s", ", ".join(map(repr, fields)))
    for key, catalog in catalogs.items():
        where = f" of catalog {catalog.label!r}" if catalog.label else ""
        logger.info("mapping selection %s%s", key, where)
        yield map_catalogs(
            fields,
            {key: catalog},
            parallel=True,
            progress=_progress_obj(progress),
        )


def load_all_maps(paths, logger):
    """Yield MapFits mappings from one or more paths."""
    from .io import MapFits

    if isinstance(paths, (str, os.PathLike)):
        paths = (paths,)
    for path in paths:
        logger.info("opening map file %s", path)
        yield MapFits(path, clobber=False)


def maps(path, *, files, logger, loader=DEFAULT_LOADER, progress,
         device="cuda"):
    """compute maps"""
    from .io import MapFits

    logger.info("configuration: %s", files)
    config = loader(files)
    fields = fields_from_config(config, device)
    out = MapFits(path, clobber=True)
    # one selection's maps in memory at a time
    for m in map_all_selections(fields, config, logger, progress, device):
        logger.info("appending %d maps to %s", len(m), path)
        out.update(m)
        del m


def alms(path, *, files, maps=None, healpix_datapath=None, logger,
         loader=DEFAULT_LOADER, progress, device="cuda"):
    """compute spherical harmonic coefficients

    Compute spherical harmonic coefficients (alms) from catalogues or
    maps.  For catalogue input, the maps for each selection are created
    in memory and discarded after its alms have been computed.
    """
    from .io import AlmFits
    from .mapping import transform

    logger.info("configuration: %s", files)
    config = loader(files)
    if healpix_datapath is not None:
        logger.info("--healpix-datapath %s is not read: quadrature weights "
                    "and pixel windows are computed", healpix_datapath)
    fields = fields_from_config(config, device)
    if maps:
        itermaps = load_all_maps(maps, logger)
    else:
        itermaps = map_all_selections(fields, config, logger, progress,
                                      device)
    out = AlmFits(path, clobber=True)
    logger.info("alms go to %s", path)
    for m in itermaps:
        logger.info("transforming a batch of %d maps", len(m))
        transform(fields, m, progress=_progress_obj(progress), out=out)
        del m


def chained_alms(alms):
    """ChainMap of AlmFits over multiple input files (or None)."""
    from collections import ChainMap

    from .io import AlmFits

    if alms is None:
        return None
    return ChainMap(*(AlmFits(a) for a in reversed(alms)))


def spectra(path, *, files, alms, alms2=None, logger, loader=DEFAULT_LOADER,
            progress, device="cuda"):
    """compute angular power spectra"""
    from .io import ClsFits
    from .twopoint import angular_power_spectra

    logger.info("configuration: %s", files)
    config = loader(files)
    all_alms, all_alms2 = chained_alms(alms), chained_alms(alms2)
    logger.info("%d alm set(s) on the auto side", len(all_alms))
    if all_alms2 is not None:
        logger.info("%d alm set(s) on the cross side", len(all_alms2))
    out = ClsFits(path, clobber=True)
    done = 0
    for label, info in spectra_from_config(config):
        logger.info("spectra set %s", _label_str(label))
        bins, weights = info.get("bins") or (None, None)
        angular_power_spectra(
            all_alms, all_alms2,
            lmax=info.get("lmax"), debias=info.get("debias", True),
            bins=bins, weights=weights,
            include=info.get("include"), exclude=info.get("exclude"),
            out=out, device=device,
        )
        logger.info("+%d spectra (%d so far)", len(out) - done, len(out))
        done = len(out)
    logger.info("%d spectra written to %s", done, path)


def mixmats(path, *, files, alms, alms2=None, logger, loader=DEFAULT_LOADER,
            progress, device="cuda"):
    """compute mixing matrices"""
    from .fields import get_masks
    from .io import MmsFits
    from .twopoint import angular_power_spectra, mixing_matrices

    logger.info("configuration: %s", files)
    config = loader(files)
    fields = fields_from_config(config, device)
    all_alms, all_alms2 = chained_alms(alms), chained_alms(alms2)
    out = MmsFits(path, clobber=True)
    done = 0
    for label, info in spectra_from_config(config):
        mask_keys = get_masks(
            fields,
            comb=2,
            include=info.get("include"),
            exclude=info.get("exclude"),
            append_eb=True,
        )
        if not mask_keys:
            logger.info("no masks for set %s; nothing to do",
                        _label_str(label))
            continue
        logger.info("mask spectra for set %s: %s", _label_str(label),
                    ", ".join(map(str, mask_keys)))
        bins, weights = info.get("bins") or (None, None)
        mask_cls = angular_power_spectra(
            all_alms,
            all_alms2,
            lmax=info.get("l3max"),
            debias=info.get("debias", True),
            include=mask_keys,
            device=device,
        )
        logger.info("mixing matrices for set %s (%d mask spectra)",
                    _label_str(label), len(mask_cls))
        mixing_matrices(
            fields,
            mask_cls,
            l1max=info.get("lmax"),
            l2max=info.get("l2max"),
            l3max=info.get("l3max"),
            bins=bins,
            weights=weights,
            progress=_progress_obj(progress),
            out=out,
            device=device,
        )
        logger.info("+%d mixmats (%d so far)", len(out) - done, len(out))
        done = len(out)
        del mask_cls
    logger.info("%d mixing matrices written to %s", done, path)


# -- argument parsing -------------------------------------------------------

# subcommand table: function -> (usage, extra argument specs).  Explicit
# usage strings replace a custom help formatter: argparse's default
# reorders positionals after options, which reads wrong for pipelines.
_COMMON_USAGE = "[-c <config>] [--no-progress] [--device <device>]"


def _common_options(parser):
    parser.add_argument(
        "-c", "--config",
        help="configuration file (can be repeated)",
        metavar="<config>", action="append", dest="files",
    )
    parser.add_argument(
        "--no-progress", help="do not show progress bars",
        action="store_false", dest="progress",
    )
    parser.add_argument(
        "--device", default="cuda", metavar="<device>",
        help="torch device of the mappers, spectra and mixing matrices "
             "(default: cuda; cpu runs the kernels' plain versions)",
    )


def _alm_inputs(parser):
    parser.add_argument("alms", nargs="+",
                        help="input FITS file(s) for alms",
                        metavar="<alms>")
    parser.add_argument("-X", nargs="+",
                        help="input FITS file(s) for cross-spectra",
                        metavar="<alms>", dest="alms2")


def main(argv=None):
    """Entry point of the ``heracles-tpu-torch`` command (``argv``: the
    arguments, by default the process's)."""
    top = argparse.ArgumentParser(
        prog="heracles-tpu-torch",
        description="harmonic-space statistics on the sphere, on PyTorch",
    )
    top.set_defaults(cmd=None)
    sub = top.add_subparsers(
        title="commands", metavar="<command>",
        help="the processing step to carry out",
    )

    def command(func, usage_tail):
        summary, _, details = (func.__doc__ or "").strip().partition("\n")
        parser = sub.add_parser(
            func.__name__,
            help=summary,
            description=details.strip() or summary,
            usage=f"%(prog)s {_COMMON_USAGE} {usage_tail}",
        )
        _common_options(parser)
        parser.set_defaults(cmd=func)
        return parser

    command(maps, "<maps>").add_argument(
        "path", help="output FITS file for maps", metavar="<maps>"
    )

    p = command(alms, "[--healpix-datapath <path>] <alms> [<maps> ...]")
    p.add_argument("--healpix-datapath", metavar="<path>",
                   help="path to HEALPix data files (accepted for "
                        "compatibility; quadrature weights are computed)")
    p.add_argument("path", help="output FITS file for alms",
                   metavar="<alms>")
    p.add_argument("maps", nargs="*", default=None,
                   help="input FITS file(s) for maps", metavar="<maps>")

    p = command(spectra, "<spectra> <alms> [<alms> ...] [-X <alms> ...]")
    p.add_argument("path", help="output FITS file for spectra",
                   metavar="<spectra>")
    _alm_inputs(p)

    p = command(mixmats, "<mixmats> <alms> [<alms> ...] [-X <alms> ...]")
    p.add_argument("path", help="output FITS file for mixing matrices",
                   metavar="<mixmats>")
    _alm_inputs(p)

    args = top.parse_args(argv)
    if args.cmd is None:
        top.print_help()
        return 1
    kwargs = vars(args)
    cmd = kwargs.pop("cmd")
    kwargs.setdefault("files", None)
    if not kwargs["files"]:
        kwargs["files"] = ["heracles.cfg"]

    logger = logging.getLogger(__name__)
    logger.addHandler(logging.StreamHandler())
    logger.setLevel(logging.DEBUG)
    try:
        cmd(**kwargs, logger=logger)
    except Exception as exc:  # noqa: BLE001
        logger.debug("traceback:", exc_info=exc)
        logger.error(f"ERROR: {exc!s}")
        return 1
    return 0
