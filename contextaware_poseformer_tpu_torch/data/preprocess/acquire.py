"""Dataset acquisition: Human3.6M archive download/verify/extract and
MPI-INF-3DHP train/test-set fetch.

Re-designs the reference's credential-gated site scripts
(H36M-Toolbox/download_all.py:12-100, extract_all.py:21-46,
ContextPose_mpi/dataset/mpi_inf_3dhp/get_dataset.sh, get_testset.sh) as one
testable module: network IO goes through an injectable `Fetcher` callable
(tests use a mock; the default uses urllib with resumable range requests
instead of the reference's external `axel` dependency), MD5 verification is
done streaming, and tgz/zip extraction guards against path traversal (the
reference extracts untrusted archives unchecked).

Both datasets are gated by their owners:
  - Human3.6M needs a logged-in browser session cookie (PHPSESSID) from
    http://vision.imar.ro/human3.6m/ — same contract as the reference.
  - MPI-INF-3DHP is a plain HTTP fetch from the official host after
    agreeing to the license (the reference's conf.ig `ready_to_download`).

CLI:
    python -m contextaware_poseformer_tpu_torch.data.preprocess.acquire h36m \
        --phpsessid <cookie> --dest data/h36m-fetch [--extract]
    python -m contextaware_poseformer_tpu_torch.data.preprocess.acquire mpi3dhp \
        --dest dataset [--subjects 1-8] [--masks] [--testset]

The port's copy of ``contextaware_poseformer_tpu/data/preprocess/acquire.py``
(held to it by ``tests/test_torch_copies.py``).
"""

from __future__ import annotations

import argparse
import hashlib
import os
import shutil
import tarfile
import zipfile
from typing import Callable, Mapping, Sequence

# (subject tag, site file id) — download_all.py:14-22
H36M_SUBJECTS: Sequence[tuple[str, int]] = (
    ("S1", 1), ("S5", 6), ("S6", 7), ("S7", 2),
    ("S8", 3), ("S9", 4), ("S11", 5),
)
H36M_BASE_URL = "http://vision.imar.ro/human3.6m/filebrowser.php"
H36M_KINDS: Sequence[tuple[str, str]] = (
    # (archive name prefix, site filepath) — download_all.py:66-77
    ("Poses_D2_Positions", "Poses/D2_Positions"),
    ("Poses_D3_Positions", "Poses/D3_Positions"),
    ("Poses_D3_Positions_mono", "Poses/D3_Positions_mono"),
    ("Poses_D3_Positions_mono_universal", "Poses/D3_Positions_mono_universal"),
    ("Videos", "Videos"),
)

# Published MD5s of the official archives (public dataset facts;
# H36M-Toolbox/checksums.txt). Keyed by archive file name.
H36M_MD5: Mapping[str, str] = {
    "Poses_D2_Positions_S1.tgz": "69e038858ace96ba5f6c5ccea52e95e8",
    "Poses_D3_Positions_S1.tgz": "d4ae2827d0227dea8c88e6a082763d0a",
    "Poses_D3_Positions_mono_S1.tgz": "4c844740ba583517c74b6c496c190761",
    "Poses_D3_Positions_mono_universal_S1.tgz": "3c75f06fdf3c4f3b8fb1f8f11d18a10e",
    "Videos_S1.tgz": "d517e6c0b1112427b2a39fcbd732281c",
    "Poses_D2_Positions_S5.tgz": "7ac8c4830468a1ed3464076ee9603632",
    "Poses_D3_Positions_S5.tgz": "7a0bd0f458612decc9de0a04e0b589cc",
    "Poses_D3_Positions_mono_S5.tgz": "4e14165ed00b7aff1111a81c1ca4b7b3",
    "Poses_D3_Positions_mono_universal_S5.tgz": "a0c821f5501fcc450e28c38e5ebd0c17",
    "Videos_S5.tgz": "02ef041813c3a37b137f86df24419e5a",
    "Poses_D2_Positions_S6.tgz": "5f9706d5259f648cca802c069dec9681",
    "Poses_D3_Positions_S6.tgz": "0970a30cbc947c3c0454c834db9b84e0",
    "Poses_D3_Positions_mono_S6.tgz": "9681696b33a0d487493330e825b408d6",
    "Poses_D3_Positions_mono_universal_S6.tgz": "dce0fb2f44b487b2bd36f603d1ff894a",
    "Videos_S6.tgz": "a4b8690e5320c5854f99f60bf31cbabc",
    "Poses_D2_Positions_S7.tgz": "543c4053c962db54d1d7361d4accffb4",
    "Poses_D3_Positions_S7.tgz": "abeea2a40650517cefb7cd911caa6472",
    "Poses_D3_Positions_mono_S7.tgz": "807109c1a304ce67c6f0cc06a94846fc",
    "Poses_D3_Positions_mono_universal_S7.tgz": "848717a95a96336ec7707b20ec463965",
    "Videos_S7.tgz": "79caf93c6ec31b1c14cd1d31d5f292e0",
    "Poses_D2_Positions_S8.tgz": "e9de190d782452edc954ac191907adcf",
    "Poses_D3_Positions_S8.tgz": "5695796fe478579ffe9b9ff09203dd27",
    "Poses_D3_Positions_mono_S8.tgz": "da8b6c948e7dcd280061cd4d99d7352f",
    "Poses_D3_Positions_mono_universal_S8.tgz": "8f5182924c29721d9c4227aa43e3d7b3",
    "Videos_S8.tgz": "18818148e68fcd80fce1efa82f98126d",
    "Poses_D2_Positions_S9.tgz": "232c2244afae96cb900908c6825d478c",
    "Poses_D3_Positions_S9.tgz": "fce28bb66bf9908016e2d9738e5cb2db",
    "Poses_D3_Positions_mono_S9.tgz": "0fad285a69fdcdf4958cc4c80d93abbc",
    "Poses_D3_Positions_mono_universal_S9.tgz": "bbc436bc0f35bd09e272ad0ed1f188e2",
    "Videos_S9.tgz": "3e7d923d5c573ac833334a31b5f8a797",
    "Poses_D2_Positions_S11.tgz": "df1fde6b5656729336f54dcd79ab6e47",
    "Poses_D3_Positions_S11.tgz": "729e93d4e50c806f4a55fd1b87e2ff52",
    "Poses_D3_Positions_mono_S11.tgz": "944a8bca62a933f5d630a835868fba23",
    "Poses_D3_Positions_mono_universal_S11.tgz": "c00b5b22ed1b88de5a536433e300503e",
    "Videos_S11.tgz": "13a24f30eb4e7cc505cbf80410c90ffe",
}

MPI3DHP_BASE_URL = "http://gvv.mpi-inf.mpg.de/3dhp-dataset"

# Fetcher: (url, dest_path, headers) -> None. Must write dest_path fully or
# raise. Injectable for tests and for users with their own downloaders.
Fetcher = Callable[[str, str, Mapping[str, str]], None]


def urllib_fetcher(url: str, dest: str, headers: Mapping[str, str]) -> None:
    """Default fetcher: urllib with resume via Range when dest.part exists
    (replaces the reference's external `axel -n 24` dependency)."""
    import urllib.request

    part = dest + ".part"
    start = os.path.getsize(part) if os.path.exists(part) else 0
    req_headers = dict(headers)
    if start:
        req_headers["Range"] = f"bytes={start}-"
    req = urllib.request.Request(url, headers=req_headers)
    with urllib.request.urlopen(req) as resp:
        mode = "ab" if start and resp.status == 206 else "wb"
        with open(part, mode) as f:
            while True:
                chunk = resp.read(1 << 20)
                if not chunk:
                    break
                f.write(chunk)
    os.replace(part, dest)


def md5_file(path: str) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def h36m_manifest() -> list[tuple[str, str]]:
    """(archive file name, full URL) for all 35 official archives."""
    files = []
    for tag, sid in H36M_SUBJECTS:
        for prefix, filepath in H36M_KINDS:
            name = f"{prefix}_{tag}.tgz"
            query = (f"download=1&filepath={filepath}"
                     f"&filename=SubjectSpecific_{sid}.tgz")
            files.append((name, f"{H36M_BASE_URL}?{query}"))
    return files


def download_h36m(
    dest_dir: str,
    phpsessid: str,
    fetcher: Fetcher = urllib_fetcher,
    checksums: Mapping[str, str] = H36M_MD5,
    verbose: bool = True,
) -> list[str]:
    """Download all H36M archives into dest_dir; skip files whose MD5
    already verifies; verify every download (raise on mismatch). Returns
    the list of archive paths."""
    os.makedirs(dest_dir, exist_ok=True)
    headers = {"Cookie": f"PHPSESSID={phpsessid}"}
    out = []
    for name, url in h36m_manifest():
        path = os.path.join(dest_dir, name)
        want = checksums.get(name)
        if os.path.isfile(path) and want and md5_file(path) == want:
            out.append(path)
            continue
        if verbose:
            print(f"fetching {name} ...")
        fetcher(url, path, headers)
        if want:
            got = md5_file(path)
            if got != want:
                raise IOError(
                    f"{name}: MD5 mismatch (got {got}, want {want}) — "
                    "stale PHPSESSID usually yields an HTML login page"
                )
        out.append(path)
    return out


def _safe_members(tar: tarfile.TarFile):
    """Regular-file members with traversal-safe relative names."""
    for m in tar.getmembers():
        if not m.isreg():
            continue
        name = os.path.normpath(m.name)
        if name.startswith(("..", "/")) or os.path.isabs(name):
            raise IOError(f"unsafe archive member path: {m.name!r}")
        yield m


def extract_tgz_flat(tgz_path: str, dest_dir: str) -> None:
    """Extract regular files, stripping the members' common directory
    prefix (extract_all.py:21-30 semantics), with traversal guards.

    Extraction is atomic: files land in a sibling temp dir that is
    os.replace'd into place on success, so a partially-extracted tree from
    an interrupted run is never mistaken for a complete one (only a fully
    extracted dest_dir short-circuits)."""
    if os.path.exists(dest_dir):
        return
    tmp_dir = dest_dir.rstrip(os.sep) + ".extracting"
    if os.path.exists(tmp_dir):
        shutil.rmtree(tmp_dir)
    with tarfile.open(tgz_path, "r:gz") as tar:
        members = list(_safe_members(tar))
        dirs = [os.path.dirname(m.name).split(os.sep) for m in members]
        common = os.sep.join(os.path.commonprefix(sorted(dirs)))
        for m in members:
            m.name = os.path.relpath(m.name, common) if common else m.name
        # members are pre-filtered above; filter="data" additionally strips
        # setuid/device bits and is the forward-compatible Py3.14 default
        tar.extractall(path=tmp_dir, members=members, filter="data")
    os.replace(tmp_dir, dest_dir)


def extract_h36m(archives_dir: str, out_dir: str,
                 verbose: bool = True) -> None:
    """archives/<kind>_<S>.tgz -> extracted/<S>/<kind>/ for all subjects
    (extract_all.py:33-46 layout)."""
    for tag, _ in H36M_SUBJECTS:
        subj_dir = os.path.join(out_dir, tag)
        os.makedirs(subj_dir, exist_ok=True)
        for prefix, _ in H36M_KINDS:
            src = os.path.join(archives_dir, f"{prefix}_{tag}.tgz")
            if not os.path.isfile(src):
                if verbose:
                    print(f"missing {src}, skipping")
                continue
            extract_tgz_flat(src, os.path.join(subj_dir, prefix))


def _unzip_flat(zip_path: str, dest_dir: str) -> None:
    """`unzip -j` semantics (flatten paths) with traversal-safe names."""
    os.makedirs(dest_dir, exist_ok=True)
    with zipfile.ZipFile(zip_path) as zf:
        for info in zf.infolist():
            if info.is_dir():
                continue
            base = os.path.basename(info.filename)
            if not base:
                continue
            with zf.open(info) as src, open(
                os.path.join(dest_dir, base), "wb"
            ) as dst:
                dst.write(src.read())


def download_mpi3dhp(
    dest_dir: str,
    subjects: Sequence[int] = tuple(range(1, 9)),
    masks: bool = False,
    extra_wall_cameras: bool = False,
    extra_ceiling_cameras: bool = False,
    fetcher: Fetcher = urllib_fetcher,
    verbose: bool = True,
) -> None:
    """Per-subject/sequence annot.mat + camera.calibration + video zips,
    unzipped flat and removed (get_dataset.sh semantics)."""
    seq_sets = ["imageSequence"] + (
        ["FGmasks", "ChairMasks"] if masks else []
    )
    zips = ["vnect_cameras.zip"]
    if extra_wall_cameras:
        zips.append("other_angled_cameras.zip")
    if extra_ceiling_cameras:
        zips.append("ceiling_cameras.zip")
    for s in subjects:
        for seq in (1, 2):
            seq_dir = os.path.join(dest_dir, f"S{s}", f"Seq{seq}")
            os.makedirs(seq_dir, exist_ok=True)
            rel = f"S{s}/Seq{seq}"
            for fname in ("annot.mat", "camera.calibration"):
                path = os.path.join(seq_dir, fname)
                if not os.path.isfile(path):
                    if verbose:
                        print(f"fetching {rel}/{fname} ...")
                    fetcher(f"{MPI3DHP_BASE_URL}/{rel}/{fname}", path, {})
            for im in seq_sets:
                im_dir = os.path.join(seq_dir, im)
                os.makedirs(im_dir, exist_ok=True)
                for z in zips:
                    zpath = os.path.join(im_dir, z)
                    if not os.path.isfile(zpath):
                        fetcher(f"{MPI3DHP_BASE_URL}/{rel}/{im}/{z}",
                                zpath, {})
                    _unzip_flat(zpath, im_dir)
                    os.remove(zpath)


def download_mpi3dhp_testset(
    dest_dir: str, fetcher: Fetcher = urllib_fetcher,
) -> None:
    """mpi_inf_3dhp_test_set.zip -> dest/mpi_inf_3dhp_test_set/
    (get_testset.sh; zip paths preserved, not flattened)."""
    os.makedirs(dest_dir, exist_ok=True)
    zpath = os.path.join(dest_dir, "mpi_inf_3dhp_test_set.zip")
    if not os.path.isfile(zpath):
        fetcher(f"{MPI3DHP_BASE_URL}/mpi_inf_3dhp_test_set.zip", zpath, {})
    out = os.path.join(dest_dir, "mpi_inf_3dhp_test_set")
    with zipfile.ZipFile(zpath) as zf:
        for info in zf.infolist():
            name = os.path.normpath(info.filename)
            if name.startswith(("..", "/")) or os.path.isabs(name):
                raise IOError(f"unsafe archive member path: {info.filename!r}")
        zf.extractall(out)
    os.remove(zpath)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    h = sub.add_parser("h36m", help="download + verify H36M archives")
    h.add_argument("--phpsessid", required=True,
                   help="logged-in session cookie from vision.imar.ro")
    h.add_argument("--dest", default="data/h36m-fetch")
    h.add_argument("--extract", action="store_true",
                   help="also extract into <dest>/extracted")
    m = sub.add_parser("mpi3dhp", help="download MPI-INF-3DHP")
    m.add_argument("--dest", default="dataset")
    m.add_argument("--subjects", default="1-8",
                   help="e.g. 1-8 or 1,2,5")
    m.add_argument("--masks", action="store_true")
    m.add_argument("--testset", action="store_true",
                   help="fetch the test set instead of train subjects")
    args = ap.parse_args(argv)

    if args.cmd == "h36m":
        archives = os.path.join(args.dest, "archives")
        download_h36m(archives, args.phpsessid)
        if args.extract:
            extract_h36m(archives, os.path.join(args.dest, "extracted"))
    elif args.cmd == "mpi3dhp":
        if args.testset:
            download_mpi3dhp_testset(args.dest)
        else:
            if "-" in args.subjects:
                lo, hi = args.subjects.split("-")
                subjects = list(range(int(lo), int(hi) + 1))
            else:
                subjects = [int(s) for s in args.subjects.split(",")]
            download_mpi3dhp(args.dest, subjects, masks=args.masks)


if __name__ == "__main__":
    main()
