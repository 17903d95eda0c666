"""YAML config with secret hygiene (reference: zuds/secrets.py:21-93).

The config is a flat YAML mapping of ``key: scalar`` lines (a scalar may
be ``null``, a bool, a number, a plain or quoted string, or an inline
``{k: v, ...}`` mapping of such scalars). :func:`parse_config` reads that
subset without a YAML library.

Config file resolution order:
  1. ``$ZUDS_CONFIG`` if set
  2. ``~/.zuds-tpu``
seeded from ``zuds_tpu/config/default.conf.yaml`` on first use. Files with
group- or world-readable permissions are refused, since the config holds
database and service credentials.
"""
import os
import re
import shutil
import stat
from pathlib import Path

__all__ = ['get_secret', 'load_config', 'parse_config']


DEFAULT_CONFIG = Path(__file__).parent / 'config' / 'default.conf.yaml'


_INT = re.compile(r'[-+]?(0|[1-9][0-9_]*)$')
_FLOAT = re.compile(r'[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$')
_BOOLS = {'true': True, 'yes': True, 'on': True,
          'false': False, 'no': False, 'off': False}


def _strip_comment(text):
    """Drop a trailing ``# comment`` that is outside quotes."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in '\'"':
            quote = ch
        elif ch == '#' and (i == 0 or text[i - 1] in ' \t'):
            return text[:i]
    return text


def _split_top(text, sep):
    """Split on ``sep`` outside quotes and braces."""
    parts, depth, quote, start = [], 0, None, 0
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in '\'"':
            quote = ch
        elif ch == '{':
            depth += 1
        elif ch == '}':
            depth -= 1
        elif ch == sep and depth == 0:
            parts.append(text[start:i])
            start = i + 1
    parts.append(text[start:])
    return parts


def _scalar(text):
    t = text.strip()
    if t.startswith('{'):
        if not t.endswith('}'):
            raise ValueError(f'unterminated inline mapping: {t!r}')
        body = t[1:-1].strip()
        out = {}
        for item in (_split_top(body, ',') if body else []):
            key, sep, val = item.partition(':')
            if not sep:
                raise ValueError(f'inline mapping item without ":": {item!r}')
            out[_scalar(key)] = _scalar(val)
        return out
    if len(t) >= 2 and t[0] == t[-1] == "'":
        return t[1:-1].replace("''", "'")
    if len(t) >= 2 and t[0] == t[-1] == '"':
        return t[1:-1].encode('latin-1', 'backslashreplace').decode(
            'unicode_escape')
    if t in ('', '~') or t.lower() == 'null':
        return None
    if t.lower() in _BOOLS:
        return _BOOLS[t.lower()]
    if _INT.match(t):
        return int(t.replace('_', ''))
    if _FLOAT.match(t) and any(c.isdigit() for c in t):
        return float(t.replace('_', ''))
    return t


def parse_config(text):
    """Parse the flat ``key: scalar`` YAML subset of the config file.

    Blank lines, ``#`` comments and a leading ``---`` are skipped. Any
    other line that is not ``key: value`` at column 0 raises ValueError,
    so a config this loader cannot read fails loudly instead of losing
    keys.
    """
    out = {}
    for n, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.strip() == '---':
            continue
        if line[0] in ' \t-':
            raise ValueError(f'config line {n}: only flat "key: value" '
                             f'lines are supported: {raw!r}')
        key, sep, val = line.partition(':')
        if not sep or (val and val[0] not in ' \t'):
            raise ValueError(f'config line {n}: expected "key: value": '
                             f'{raw!r}')
        out[_scalar(key)] = _scalar(val)
    return out


class SecretManager:

    def __init__(self):
        self.cache = None
        self.path = None

    def config_path(self):
        env = os.getenv('ZUDS_CONFIG')
        if env:
            return Path(env)
        return Path.home() / '.zuds-tpu'

    def initialize_config(self, path):
        path.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(DEFAULT_CONFIG, path)
        os.chmod(path, stat.S_IRUSR | stat.S_IWUSR)

    def load_config(self, reload=False):
        if self.cache is not None and not reload:
            return self.cache
        path = self.config_path()
        if not path.exists():
            self.initialize_config(path)
        mode = os.stat(path).st_mode
        if mode & (stat.S_IRGRP | stat.S_IROTH | stat.S_IWGRP | stat.S_IWOTH):
            raise PermissionError(
                f'config file {path} must not be group/world accessible; '
                f'run: chmod 600 {path}')
        with open(path) as f:
            self.cache = parse_config(f.read())
        self.path = path
        return self.cache

    def get(self, key, default=None):
        return self.load_config().get(key, default)


_manager = SecretManager()


def load_config(reload=False):
    return _manager.load_config(reload=reload)


def get_secret(key, default=None):
    return _manager.get(key, default)
