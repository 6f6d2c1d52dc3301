"""Recursive extension-based file iteration.

The port's copy of what a benchmark set's loading needs from the JAX
package's ``utils/filesystem.py`` (the tree-mirroring helper comes with the
tooling).
reference: python3/src/pushworld/utils/filesystem.py:21-159 (behavioral parity:
recursive discovery preserving subdirectory trees; duplicate-name detection).
"""

import os
from typing import Dict, Iterator


def iter_files_with_extension(path: str, extension: str) -> Iterator[str]:
    """Yields all files under ``path`` (a file or directory) that end with
    ``extension``.  Directories are walked recursively in sorted order."""
    if os.path.isfile(path):
        if path.endswith(extension):
            yield path
        return
    if not os.path.isdir(path):
        raise FileNotFoundError(f"No such file or directory: {path}")
    for root, dirs, files in os.walk(path):
        dirs.sort()
        for name in sorted(files):
            if name.endswith(extension):
                yield os.path.join(root, name)


def get_puzzle_file_paths(path: str, extension: str = ".pwp") -> Dict[str, str]:
    """Maps puzzle names (file basenames without extension) to their paths.

    Raises ``ValueError`` if two files share the same puzzle name."""
    result: Dict[str, str] = {}
    for file_path in iter_files_with_extension(path, extension):
        name = os.path.basename(file_path)[: -len(extension)]
        if name in result:
            raise ValueError(
                f"Duplicate puzzle name '{name}': {result[name]} and {file_path}"
            )
        result[name] = file_path
    return result
