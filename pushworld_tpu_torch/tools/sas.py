"""SAS export via the Fast Downward translator.

The port's copy of the JAX package's ``tools/sas.py``.  Fast Downward is not
part of the repository: ``PUSHWORLD_FAST_DOWNWARD`` names it.

reference behavior: python3/src/pushworld/sas.py:21-84 — shells out to
``fast-downward.py --translate`` per PDDL domain/problem pair; batch version
walks a directory of pairs and writes ``.sas`` next to them.
"""

import os
import subprocess

from pushworld_tpu_torch import config


def pddl_to_sas(
    domain_file_path: str,
    problem_file_path: str,
    sas_file_path: str,
    fast_downward_executable: str = config.FAST_DOWNWARD_PATH,
) -> None:
    """Translates one PDDL pair into a ``.sas`` file with Fast Downward."""
    if not fast_downward_executable:
        raise RuntimeError(
            "Fast Downward not configured; set PUSHWORLD_FAST_DOWNWARD to the "
            "path of fast-downward.py."
        )
    proc = subprocess.Popen(
        [
            fast_downward_executable,
            "--translate",
            "--sas-file",
            sas_file_path,
            domain_file_path,
            problem_file_path,
        ],
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
    )
    out = proc.communicate()[0].decode("utf-8")
    if "translate exit code: 0" not in out:
        raise RuntimeError(
            f"Failed to convert {domain_file_path} and {problem_file_path} "
            "into SAS format."
        )


def convert_all_pddls_to_sas(
    pddl_path: str,
    fast_downward_executable: str = config.FAST_DOWNWARD_PATH,
    domain_suffix: str = config.DOMAIN_SUFFIX,
    problem_suffix: str = config.PROBLEM_SUFFIX,
) -> None:
    """Translates every PDDL pair under ``pddl_path`` (pairs must share a
    directory) into ``.sas`` files written alongside."""
    for subdir, _, filenames in os.walk(pddl_path):
        for filename in sorted(filenames):
            if not filename.endswith(domain_suffix):
                continue
            base = os.path.join(subdir, filename)[: -len(domain_suffix)]
            pddl_to_sas(
                domain_file_path=base + domain_suffix,
                problem_file_path=base + problem_suffix,
                sas_file_path=base + ".sas",
                fast_downward_executable=fast_downward_executable,
            )
