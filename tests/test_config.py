import os
import stat

import pytest


def test_config_seeded_and_permission_enforced(tmp_config):
    from zuds_tpu.secrets import get_secret, load_config
    cfg = load_config(reload=True)
    assert 'base_data_directory' in cfg
    assert get_secret('db_backend') == 'sqlite'
    # loosen permissions -> refused
    import zuds_tpu.secrets as secrets
    path = secrets._manager.config_path()
    os.chmod(path, 0o644)
    with pytest.raises(PermissionError):
        load_config(reload=True)
    os.chmod(path, 0o600)
    assert load_config(reload=True)


def test_get_secret_default(tmp_config):
    from zuds_tpu.secrets import get_secret
    assert get_secret('definitely_not_a_key', 'fallback') == 'fallback'


def test_quick_background_estimate(rng):
    import numpy as np
    from zuds_tpu.utils import quick_background_estimate
    data = rng.normal(150.0, 12.0, size=(512, 512))
    med, sigma = quick_background_estimate(data)
    assert med == pytest.approx(150.0, abs=0.5)
    assert sigma == pytest.approx(12.0, rel=0.05)


def test_mjd_from_header():
    from zuds_tpu.fits import Header
    from zuds_tpu.utils import mjd_from_header
    h = Header()
    h.set('OBSMJD', 58345.25)
    assert mjd_from_header(h) == 58345.25
    h2 = Header()
    h2.set('DATE-OBS', '2018-08-15T06:00:00.0')
    assert mjd_from_header(h2) == pytest.approx(58345.25, abs=1e-6)


def test_tracing_spans():
    """Structured tracing subsystem (SURVEY §5 gap: the reference has
    print-based timing only)."""
    import io
    import zuds_tpu.tracing as tracing
    tracing.reset()
    with tracing.timed('stage_a'):
        pass
    with tracing.timed('stage_a'):
        pass
    with tracing.timed('stage_b'):
        pass
    snap = tracing.spans()
    assert snap['stage_a'][0] == 2
    assert snap['stage_b'][0] == 1
    buf = io.StringIO()
    tracing.report(buf)
    out = buf.getvalue()
    assert 'stage_a' in out and 'mean' in out

    @tracing.traced('deco')
    def f(x):
        return x + 1

    assert f(1) == 2
    assert tracing.spans()['deco'][0] == 1

    import zuds_tpu as zuds
    assert zuds.timed is tracing.timed


def test_parse_config_matches_yaml_on_default():
    """The flat loader reads the shipped default config exactly as a YAML
    parser does."""
    import yaml
    from zuds_tpu.secrets import DEFAULT_CONFIG, parse_config
    text = DEFAULT_CONFIG.read_text()
    assert parse_config(text) == yaml.safe_load(text)


@pytest.mark.parametrize('values', [
    {'db_backend': 'postgres', 'db_port': 5432, 'db_password': None,
     'db_host': 'localhost'},
    {'base_data_directory': '/tmp/x y/hot', 'ratio': 1.5, 'flag': True,
     'quoted': "it's", 'numeric_string': '123', 'empty': '',
     'hash': 'a # b', 'tilde': '~/.zuds-tpu.db', 'word_null': 'null'},
])
def test_parse_config_reads_yaml_dumps(values):
    """Configs the tests rewrite with yaml.safe_dump load back intact."""
    import yaml
    from zuds_tpu.secrets import parse_config
    assert parse_config(yaml.safe_dump(values)) == values


def test_parse_config_inline_mapping_and_comments():
    from zuds_tpu.secrets import parse_config
    cfg = parse_config('---\n# heading\n\nmesh: {data: 4, model: 1}  # c\n'
                       "path: '/a#b' # trailing\nnone: ~\n")
    assert cfg == {'mesh': {'data': 4, 'model': 1}, 'path': '/a#b',
                   'none': None}


@pytest.mark.parametrize('text', ['nested:\n  key: 1\n', '- item\n',
                                  'novalue\n', 'a:b\n'])
def test_parse_config_rejects_unsupported(text):
    from zuds_tpu.secrets import parse_config
    with pytest.raises(ValueError):
        parse_config(text)
