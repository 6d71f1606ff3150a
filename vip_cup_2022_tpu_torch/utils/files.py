"""Dataset-file collectors (counterpart of ``vip_cup_2022_tpu/utils/files.py``).

``collect_files_with_suffix`` recurses local directories and flattens lists
of files and directories; ``s3://`` URLs go through a gated ``boto3`` import,
which raises ``NotImplementedError`` where the AWS SDK is not installed.
"""
from __future__ import annotations

from pathlib import Path
from typing import Iterable, List, Tuple, Union

TFRECORD_SUFFIXES = (".tfrecord", ".tfrec")


def collect_tfrecord_files(data_dir) -> List[str]:
    """Every tfrecord file under ``data_dir`` (a file, a directory or an
    iterable of both)."""
    return collect_files_with_suffix(data_dir, TFRECORD_SUFFIXES)


def collect_files_with_suffix(
    data_dir: Union[None, str, Path, Iterable],
    suffix: Union[str, Tuple[str, ...]],
) -> List[str]:
    """Every file with one of the suffixes in the locations of ``data_dir``,
    sorted: a matching file is itself, a directory recurses, a list, tuple
    or set flattens, None gives none."""
    suffix = (suffix,) if isinstance(suffix, str) else tuple(suffix)
    if data_dir is None:
        return []
    if isinstance(data_dir, (list, tuple, set)):
        return sorted(f for d in data_dir for f in collect_files_with_suffix(d, suffix))
    data_dir = str(data_dir)
    if data_dir.startswith("s3://"):
        return sorted(_collect_s3_files(data_dir, suffix))
    return sorted(_collect_local_files(data_dir, suffix))


def _collect_local_files(data_dir: str, suffix: Tuple[str, ...]) -> List[str]:
    path = Path(data_dir)
    if path.suffix in suffix:
        return [str(path)]
    if path.is_dir():
        return [str(f) for s in suffix for f in path.rglob(f"*{s}")]
    return []


def _collect_s3_files(data_dir: str, suffix: Tuple[str, ...]) -> List[str]:
    if data_dir.endswith(suffix):
        return [data_dir]
    try:
        import boto3  # gated: listing a bucket needs the AWS SDK
    except ImportError as e:
        raise NotImplementedError(
            "S3 file collection requires boto3, which is not installed in "
            "this (no-egress) environment; pass local paths instead"
        ) from e
    bucket, _, prefix = data_dir[len("s3://"):].partition("/")
    s3 = boto3.client("s3")
    keys: List[str] = []
    kwargs = {"Bucket": bucket, "Prefix": prefix}
    while True:
        resp = s3.list_objects_v2(**kwargs)
        keys.extend(f"s3://{bucket}/{obj['Key']}" for obj in resp.get("Contents", [])
                    if obj["Key"].endswith(suffix))
        if not resp.get("IsTruncated"):
            break
        kwargs["ContinuationToken"] = resp["NextContinuationToken"]
    return keys
