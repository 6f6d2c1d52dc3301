"""Recursive extension-based file iteration and tree-mirroring helpers.

The port's copy of the JAX package's ``utils/filesystem.py``.
reference: python3/src/pushworld/utils/filesystem.py:21-159 (behavioral parity:
recursive discovery preserving subdirectory trees; duplicate-name detection).
"""

import os
from typing import Dict, Iterator, List, Tuple


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


def map_files_with_extension(
    input_path: str,
    input_extension: str,
    output_path: str,
    output_extension: str,
) -> List[Tuple[str, str]]:
    """Pairs every input file having ``input_extension`` under ``input_path``
    with an output path under ``output_path`` mirroring the subdirectory tree,
    creating output directories as needed."""
    pairs = []
    input_is_file = os.path.isfile(input_path)
    for in_file in iter_files_with_extension(input_path, input_extension):
        if input_is_file:
            rel = os.path.basename(in_file)
        else:
            rel = os.path.relpath(in_file, input_path)
        rel_out = rel[: -len(input_extension)] + output_extension
        out_file = os.path.join(output_path, rel_out)
        os.makedirs(os.path.dirname(out_file), exist_ok=True)
        pairs.append((in_file, out_file))
    return pairs


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
