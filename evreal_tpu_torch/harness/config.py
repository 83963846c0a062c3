"""Config resolution (``evreal_tpu/harness/config.py``; reference
eval.py:28-35, 82-89, 118-121): JSON files by name under
``config/{eval,method,dataset}``, searched in the current working
directory first and the repository root second. The files are data; the
JAX package's tree is shared through the repository root's ``config``."""

import json
import os

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__),
                                          os.pardir, os.pardir))


def _find(group, name):
    bases = (os.getcwd(), REPO_ROOT)
    for base in bases:
        path = os.path.join(base, "config", group, name + ".json")
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"config/{group}/{name}.json not found under "
                            + ", ".join(bases))


def read_json(path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _named(group, names):
    out = []
    for name in names:
        cfg = read_json(_find(group, name))
        cfg["name"] = name
        out.append(cfg)
    return out


def get_eval_configs(names):
    return _named("eval", names)


def get_dataset_configs(names):
    return _named("dataset", names)


def get_method_config(name):
    return read_json(_find("method", name))

