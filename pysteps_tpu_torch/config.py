"""
Configuration bootstrap (counterpart of ``pysteps_tpu/config.py``).

Loads an rc file (JSON with ``//`` comments) describing data sources and
output paths and exposes it as the attribute-accessible dot-dict
``rcparams``.  The search order and the file names are the JAX package's,
so one rc file configures both packages: ``$PYSTEPS_TPU_RC`` >
``./pysteps_tpu_rc`` (or ``./pystepsrc``) >
``$HOME/.pysteps_tpu/pysteps_tpu_rc`` > the defaults packaged with this
package (``pysteps_tpu_torch/pysteps_tpu_rc``, validated against
``pysteps_tpu_torch/pysteps_tpu_rc_schema.json``).
"""

import json
import os
import warnings

_HERE = os.path.dirname(os.path.abspath(__file__))


class DotDict(dict):
    """Dict with attribute access, applied recursively to nested dicts."""

    def __getattr__(self, name):
        try:
            value = self[name]
        except KeyError as err:
            raise AttributeError(name) from err
        if isinstance(value, dict) and not isinstance(value, DotDict):
            value = DotDict(value)
            self[name] = value
        return value

    def __setattr__(self, name, value):
        self[name] = value


_DEFAULT_RC = {
    "outputs": {"path_workdir": "./tmp"},
    "silent_import": False,
    "plot": {"motion_plot": "quiver", "colorscale": "pysteps"},
    "data_sources": {},
}


def _strip_json_comments(text):
    """Remove the ``//`` comments that are not inside a string, line by
    line (rc files keep comments on lines of their own or after values)."""
    out_lines = []
    for line in text.splitlines():
        in_str = False
        prev = ""
        cut = len(line)
        for i, ch in enumerate(line):
            if ch == '"' and prev != "\\":
                in_str = not in_str
            if not in_str and ch == "/" and i + 1 < len(line) and line[i + 1] == "/":
                cut = i
                break
            prev = ch
        out_lines.append(line[:cut])
    return "\n".join(out_lines)


def _candidate_paths():
    env = os.environ.get("PYSTEPS_TPU_RC")
    if env:
        yield env
        if os.path.isdir(env):
            yield os.path.join(env, "pysteps_tpu_rc")
    for name in ("pysteps_tpu_rc", "pystepsrc"):
        yield os.path.join(os.getcwd(), name)
    home = os.environ.get("HOME", "")
    if home:
        yield os.path.join(home, ".pysteps_tpu", "pysteps_tpu_rc")


def config_fname():
    """The rc file :func:`load_config_file` would read: the first
    candidate that exists, else the packaged default."""
    for cand in _candidate_paths():
        if cand and os.path.isfile(cand):
            return cand
    return os.path.join(_HERE, "pysteps_tpu_rc")


def load_config_file(params_file=None, verbose=False, dryrun=False):
    """Load an rc parameter file and return it as a :class:`DotDict`.

    A file that cannot be parsed or fails the schema raises (``ValueError``
    from the JSON parser, ``RuntimeError`` listing every schema error);
    one that cannot be read leaves the defaults with a warning.
    ``dryrun=True`` parses and validates without replacing the
    module-level ``rcparams``."""
    params = json.loads(json.dumps(_DEFAULT_RC))  # deep copy
    path = None
    if params_file is not None:
        path = params_file
    else:
        for cand in _candidate_paths():
            if cand and os.path.isfile(cand):
                path = cand
                break
    if path is not None:
        try:
            with open(path) as f:
                text = f.read()
        except OSError as err:
            warnings.warn(f"could not read rc file {path}: {err}; using defaults")
        else:
            loaded = json.loads(_strip_json_comments(text))
            _validate_rc(loaded)
            params.update(loaded)
            if verbose:
                print(f"pysteps_tpu configuration loaded from {path}")
    if dryrun:
        return DotDict(params)
    global rcparams
    rcparams = DotDict(params)
    return rcparams


_JSON_TYPES = {
    "object": dict,
    "array": list,
    "string": str,
    "boolean": bool,
    "integer": int,
    "number": (int, float),
}


def _schema_errors(instance, schema, path=()):
    """(path, message) for each violation of the Draft-4 subset the rc
    schema uses (type, required, properties, patternProperties)."""
    typ = schema.get("type")
    if typ is not None:
        pytype = _JSON_TYPES[typ]
        ok = isinstance(instance, pytype)
        if typ in ("integer", "number") and isinstance(instance, bool):
            ok = False
        if not ok:
            yield path, f"{instance!r} is not of type '{typ}'"
            return
    if isinstance(instance, dict):
        for req in schema.get("required", ()):
            if req not in instance:
                yield path, f"'{req}' is a required property"
        props = schema.get("properties", {})
        for key, sub in props.items():
            if key in instance:
                yield from _schema_errors(instance[key], sub, path + (key,))
        for _pattern, sub in schema.get("patternProperties", {}).items():
            # the rc schema uses the match-everything pattern ""
            for key, value in instance.items():
                if key not in props:
                    yield from _schema_errors(value, sub, path + (key,))


def _rc_schema():
    with open(os.path.join(_HERE, "pysteps_tpu_rc_schema.json")) as f:
        return json.load(f)


def _validate_rc(params):
    """Raise ``RuntimeError`` with one line per schema error of the rc
    contents."""
    errors = list(_schema_errors(params, _rc_schema()))
    if errors:
        error_msg = "Error reading pystepsrc file."
        for path, message in errors:
            error_msg += "\nError in " + "/".join(path)
            error_msg += ": " + message
        raise RuntimeError(error_msg)


rcparams = DotDict(json.loads(json.dumps(_DEFAULT_RC)))
load_config_file()
