"""Command-line develop: ``python -m pysp_tpu.cli develop shot.dng -o out.png``.

The reference has no CLI (README.md usage is import-only); this is the minimal
production surface over the same pipeline: load -> (optional corrections) ->
develop -> save, with per-stage stats and timing.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pysp_tpu", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)

    dev = sub.add_parser("develop", help="develop raw file(s) to sRGB images")
    dev.add_argument(
        "inputs",
        nargs="+",
        help="raw file path(s) (DNG/CR2/NEF/ARW/RW2/ORF/RAF/PEF/MRW/SRW built in; others via rawpy)",
    )
    dev.add_argument("-o", "--output", help="output path (single input) or directory")
    dev.add_argument(
        "--quality", choices=["draft", "fast", "best"], default="best"
    )
    dev.add_argument("--postprocess", type=int, default=1,
                     help="AHD chroma-median stages (best quality only)")
    dev.add_argument("--no-gamma", action="store_true",
                     help="emit linear sRGB instead of gamma-encoded")
    dev.add_argument("--highlights", choices=["clip", "reconstruct"],
                     default="clip",
                     help="blown-highlight handling: clip at white (reference "
                          "behavior) or rebuild clipped channels from "
                          "unclipped ones with a soft-knee rolloff")
    dev.add_argument("--temperature", type=float, default=None,
                     help="override WB by color temperature (Kelvin)")
    dev.add_argument("--repair-hot-pixels", action="store_true")
    dev.add_argument("--denoise", type=float, default=0.0, metavar="STRENGTH",
                     help="Bayer-domain wavelet noise reduction before "
                          "demosaic (~1.0 targets the estimated noise floor)")
    dev.add_argument("--ca", nargs="?", const="template", default=None,
                     choices=["template", "gradient", "refine"],
                     help="fit and remove lateral chromatic aberration. "
                          "'template' (default): blind in-mosaic Poly5 tile "
                          "template-match fit; 'gradient': differentiable "
                          "Poly3 fit by Adam descent on channel alignment "
                          "(works on featureless scenes too); 'refine': "
                          "template fit polished by gradient descent")
    dev.add_argument("--warp", action="store_true",
                     help="apply the file's embedded DNG OpcodeList3 "
                          "rectilinear warp to the output")
    dev.add_argument("--unsharp", metavar="AMOUNT[:RADIUS]",
                     help="Oklab-L unsharp mask on the linear image "
                          "(default radius 2.0)")
    dev.add_argument("--deconv", metavar="SIGMA[:ITERS]",
                     help="Richardson-Lucy luma deconvolution on the linear "
                          "image (default 20 iterations)")
    dev.add_argument("--blur", type=float, metavar="SIGMA",
                     help="Gaussian blur on the linear image")
    dev.add_argument("--hdr", action="store_true",
                     help="fuse ALL inputs as an exposure bracket into one HDR output")
    dev.add_argument("--flat", help="flat-field raw (vignetting/dust correction)")
    dev.add_argument("--dark", help="dark-frame raw (subtracted before develop)")
    dev.add_argument("--stats", action="store_true", help="print develop statistics")
    dev.add_argument("--bit-depth", type=int, choices=[8, 16], default=8,
                     help="output sample depth: 16 writes 16-bit PNGs via the "
                          "native fast writer (TIFF output is always 16-bit)")
    dev.add_argument("--save-params", metavar="FILE",
                     help="write fitted develop parameters (CA model "
                          "coefficients, WB) to a JSON sidecar after this "
                          "develop — fit once, reuse with --params")
    dev.add_argument("--params", metavar="FILE",
                     help="apply develop parameters from a JSON sidecar "
                          "(skips CA re-fitting; restores saved WB)")

    info = sub.add_parser("info", help="print raw metadata")
    info.add_argument("input")

    hv = sub.add_parser(
        "harvest",
        help="pull REAL per-body ColorMatrix1/2 calibration out of DNG file(s) "
             "or directory tree(s) into the persistent registry cache, so "
             "native-format loads (CR2/NEF/ARW/...) of the same bodies stop "
             "using estimated StdA matrices; prints estimate-vs-real deltas",
    )
    hv.add_argument("inputs", nargs="+", help="DNG file(s) and/or directories")

    vd = sub.add_parser(
        "verify-decode",
        help="cross-decode file(s) with the built-in codec AND rawpy/libraw "
             "and report bit/PSNR parity + metadata diffs (first-contact "
             "codec validation; exits 1 on any mismatch)",
    )
    vd.add_argument("inputs", nargs="+",
                    help="raw file path(s) and/or directories (directories are "
                         "swept recursively for known raw extensions; sweep "
                         "mode prints one JSON line per file plus a per-format "
                         "summary table)")
    return p


def _save_output(args, dst: str, img) -> None:
    from .io.image_out import save_image, save_png16

    if getattr(args, "bit_depth", 8) == 16 and dst.lower().endswith(".png"):
        save_png16(dst, img)
    else:
        save_image(dst, img)


def _dst_for(args, src: str) -> str:
    import os

    if args.output is None:
        return os.path.splitext(src)[0] + ".png"
    if len(args.inputs) > 1 or os.path.isdir(args.output):
        os.makedirs(args.output, exist_ok=True)
        return os.path.join(
            args.output, os.path.splitext(os.path.basename(src))[0] + ".png"
        )
    return args.output


def _develop(args) -> int:
    import numpy as np

    from . import (
        DevelopConfig,
        QualityDemosaic,
        develop,
        find_erroneous_pixels_median,
        load_raw,
        repair_bad_pixels,
    )
    from .io.image_out import save_image
    from .pipeline.develop import develop_with_stats

    quality = {
        "draft": QualityDemosaic.Draft,
        "fast": QualityDemosaic.Fast,
        "best": QualityDemosaic.Best,
    }[args.quality]
    filtering = args.unsharp or args.deconv or args.blur is not None
    cfg = DevelopConfig(
        quality=quality,
        postprocess_stages=args.postprocess,
        # Filters operate on LINEAR sRGB; gamma is re-applied after them.
        gamma_encode=not args.no_gamma and not filtering,
        highlights=args.highlights,
    )

    def _split_spec(spec, default_second):
        parts = str(spec).split(":")
        return float(parts[0]), (
            float(parts[1]) if len(parts) > 1 else default_second
        )

    def _apply_filters(out):
        if not filtering:
            return out
        import jax.numpy as jnp

        out = jnp.asarray(out)
        if args.deconv:
            from .filters.sharpen import gaussian_rt_deconvolution_yuv

            sigma, iters = _split_spec(args.deconv, 20.0)
            out = gaussian_rt_deconvolution_yuv(out, sigma, int(iters))
        if args.unsharp:
            from .filters.sharpen import unsharp_mask_lab

            amount, radius = _split_spec(args.unsharp, 2.0)
            out = unsharp_mask_lab(out, radius, amount)
        if args.blur is not None:
            from .filters.blur import blur_gaussian

            out = blur_gaussian(out, args.blur)
        if not args.no_gamma:
            from .colorimetry.transforms import lin_srgb_to_srgb

            out = lin_srgb_to_srgb(jnp.clip(out, 0.0, 1.0))
        return out

    import os

    aux = {}
    if args.flat or args.dark or args.hdr:
        from .pipeline.pipeline import PipelineConfig, develop_pipeline

        if args.flat:
            aux["flat"] = load_raw(args.flat)
        if args.dark:
            aux["dark"] = load_raw(args.dark)
        pcfg = PipelineConfig(
            develop=cfg,
            dark_frame=args.dark is not None,
            flat_field=args.flat is not None,
            repair_hot_pixels=args.repair_hot_pixels,
            hot_pixel_shared_ratio=0.5 if (args.hdr and args.repair_hot_pixels) else None,
            denoise_strength=args.denoise,
            fuse_hdr=args.hdr,
        )

    if args.hdr:
        import jax
        import jax.numpy as jnp

        if args.save_params:
            print("--save-params does nothing with --hdr (no fit runs); "
                  "ignored", file=sys.stderr)
        hdr_sidecar = None
        if args.params:
            from .utils.sidecar import load_sidecar

            hdr_sidecar = load_sidecar(args.params)

        t0 = time.time()
        frames = [load_raw(src) for src in args.inputs]
        batch = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *frames)
        if hdr_sidecar is not None:
            # saved WB + CA apply per frame BEFORE the fuse (canonical
            # sensor-space order: corrections precede HDR stacking)
            if hdr_sidecar["wb_neutral"] is not None:
                batch = batch.replace(
                    wb_neutral=jnp.broadcast_to(
                        jnp.asarray(hdr_sidecar["wb_neutral"], jnp.float32),
                        batch.wb_neutral.shape,
                    )
                )
            if (
                hdr_sidecar["ca_model_r"] is not None
                or hdr_sidecar["ca_model_b"] is not None
            ):
                from .correct.ca.removal import remove_ca_from_raw

                batch = remove_ca_from_raw(
                    batch, hdr_sidecar["ca_model_r"], hdr_sidecar["ca_model_b"]
                )
        out_host = np.asarray(_apply_filters(develop_pipeline(batch, pcfg, **aux)))
        dst = args.output or os.path.splitext(args.inputs[0])[0] + "_hdr.png"
        _save_output(args, dst, out_host)
        mp = out_host.shape[0] * out_host.shape[1] / 1e6
        dt = time.time() - t0
        print(f"{len(args.inputs)} frames -> {dst}  ({mp:.1f} MP HDR, {dt*1e3:.0f} ms)")
        return 0

    sidecar = None
    if args.params:
        from .utils.sidecar import load_sidecar

        sidecar = load_sidecar(args.params)
        if args.temperature is None and sidecar["temperature_k"] is not None:
            args.temperature = sidecar["temperature_k"]

    plain = not (args.flat or args.dark or args.temperature is not None
                 or args.repair_hot_pixels or args.stats or args.ca or args.warp
                 or args.denoise > 0.0 or filtering
                 or sidecar is not None or args.save_params)
    if plain and len(args.inputs) > 1:
        # pipelined decode -> develop -> save (stream driver)
        import os

        from .pipeline.stream import develop_files

        out_dir = args.output or os.path.dirname(args.inputs[0]) or "."
        t0 = time.time()
        written = develop_files(args.inputs, out_dir, cfg)
        dt = time.time() - t0
        for src, dst in zip(args.inputs, written):
            print(f"{src} -> {dst}")
        print(f"{len(written)} files in {dt*1e3:.0f} ms (streamed)")
        return 0

    for src in args.inputs:
        t0 = time.time()

        if args.temperature is not None:
            # rebuild the frame with re-solved WB (any supported format)
            from .io.raw_loader import controller_for_source, frame_from_parts

            frame = load_raw(src)
            ctrl = controller_for_source(src, frame)
            ctrl.update_by_temperature(args.temperature, allow_cross_blend=True)
            # un-canonicalize: frame.bayer is RGGB-canonical, frame_from_parts
            # re-canonicalizes from the source pattern orientation
            from .core.bayer import reversible_transform_rggb

            sensor = np.asarray(
                reversible_transform_rggb(frame.bayer, frame.source_pattern)
            )
            frame = frame_from_parts(
                sensor, frame.source_pattern, ctrl, float(frame.ev)
            )
        else:
            frame = load_raw(src)

        if (
            sidecar is not None
            and sidecar["wb_neutral"] is not None
            and args.temperature is None
        ):
            # restore the saved camera neutral exactly (WB gains = 1/neutral)
            import jax.numpy as jnp

            frame = frame.replace(
                wb_neutral=jnp.asarray(sidecar["wb_neutral"], jnp.float32)
            )

        fitted_r = fitted_b = None
        if sidecar is not None and (
            sidecar["ca_model_r"] is not None or sidecar["ca_model_b"] is not None
        ):
            # saved coefficients: apply without re-fitting (sidecar workflow)
            from .correct.ca.removal import remove_ca_from_raw

            fitted_r, fitted_b = sidecar["ca_model_r"], sidecar["ca_model_b"]
            frame = remove_ca_from_raw(frame, fitted_r, fitted_b)
        elif args.ca:
            from .correct.ca.removal import remove_ca_from_raw

            def _normalize(model):
                # with --save-params, apply the model exactly as the sidecar
                # will replay it (coefficients through their JSON float form),
                # so fit+save and --params replays are bit-identical
                if model is None or not args.save_params:
                    return model
                from .utils.sidecar import ca_model_from_dict, ca_model_to_dict

                return ca_model_from_dict(ca_model_to_dict(model))

            if args.ca == "gradient":
                from .correct.ca.gradfit import fit_ca_models_gradient

                model_r, model_b = fit_ca_models_gradient(frame)
                model_r, model_b = _normalize(model_r), _normalize(model_b)
                frame = remove_ca_from_raw(frame, model_r, model_b)
                fitted_r, fitted_b = model_r, model_b
            else:
                from .correct.ca.removal import compute_ca_lens_models_for_raw

                try:
                    model_r, model_b = compute_ca_lens_models_for_raw(frame)
                except ValueError as e:
                    # e.g. "Not enough tiles": featureless scene — untouched
                    print(f"{src}: CA fit failed ({e}); --ca skipped",
                          file=sys.stderr)
                else:
                    if args.ca == "refine":
                        from .correct.ca.gradfit import (
                            refine_ca_models_gradient,
                        )

                        model_r, model_b = refine_ca_models_gradient(
                            frame, model_r, model_b
                        )
                    model_r, model_b = _normalize(model_r), _normalize(model_b)
                    frame = remove_ca_from_raw(frame, model_r, model_b)
                    fitted_r, fitted_b = model_r, model_b

        if args.save_params:
            from .utils.sidecar import save_sidecar

            save_sidecar(
                args.save_params,
                ca_model_r=fitted_r,
                ca_model_b=fitted_b,
                wb_neutral=np.asarray(frame.wb_neutral, np.float64),
                temperature=args.temperature,
            )
            print(f"develop parameters -> {args.save_params}", file=sys.stderr)
            args.save_params = None  # fit state comes from the first input

        def _apply_warp(out_host, src=src):
            if not args.warp:
                return out_host
            from .io.metadata import get_opcode_3_block
            from .warp.opcodes import apply_opcode_3_warp

            block = get_opcode_3_block(src)
            if block is None:
                print(f"{src}: no OpcodeList3 block; --warp skipped",
                      file=sys.stderr)
                return out_host
            return np.asarray(apply_opcode_3_warp(out_host, block))

        if args.flat or args.dark:
            out_host = _apply_warp(
                np.asarray(_apply_filters(develop_pipeline(frame, pcfg, **aux)))
            )
            dt = time.time() - t0
            dst = _dst_for(args, src)
            _save_output(args, dst, out_host)
            mp = out_host.shape[0] * out_host.shape[1] / 1e6
            print(f"{src} -> {dst}  ({mp:.1f} MP, {dt*1e3:.0f} ms)")
            continue

        if args.repair_hot_pixels:
            masks = find_erroneous_pixels_median(frame)
            frame = repair_bad_pixels(frame, masks)

        if args.denoise > 0.0:
            from .correct.denoise import denoise_bayer_wavelet

            frame = denoise_bayer_wavelet(frame, args.denoise)

        if args.stats:
            out, stats = develop_with_stats(frame, cfg)
            host_stats = {
                k: {kk: np.asarray(vv).tolist() for kk, vv in v.items()}
                for k, v in stats.items()
            }
            print(json.dumps(host_stats, indent=2), file=sys.stderr)
        else:
            out = develop(frame, cfg)

        out_host = _apply_warp(np.asarray(_apply_filters(out)))
        dt = time.time() - t0
        dst = _dst_for(args, src)
        _save_output(args, dst, out_host)
        mp = out_host.shape[0] * out_host.shape[1] / 1e6
        print(f"{src} -> {dst}  ({mp:.1f} MP, {dt*1e3:.0f} ms)")
    return 0


def _info(args) -> int:
    import numpy as np

    from .io import tiff as T
    from .io.metadata import (
        compute_ev_from_tiff,
        exif_get_as_shot_neutral,
        exif_get_color_mat_sources,
        get_image_area_from_tiff,
        get_opcode_3_block,
    )

    from .io.arw import is_arw
    from .io.cr2 import is_cr2
    from .io.nef import is_nef
    from .io.orf import is_orf
    from .io.pef import is_pef
    from .io.raf import is_raf
    from .io.rw2 import is_rw2
    from .io.srw import is_srw

    from .io.cr3 import is_cr3

    if is_cr3(args.input):
        # metadata-only: the CRX payload needs libraw (see io/cr3.py)
        from .io.cr3 import cr3_info

        out = cr3_info(args.input)
        out["raw_decode"] = "rawpy/libraw required (CRX codec)"
        print(json.dumps(out, indent=2))
        return 0

    from .io.mrw import is_mrw

    if is_mrw(args.input):
        # MRW is a block directory, not a TIFF: report from the PRD block
        # + loader-extracted metadata
        from .io.mrw import _parse_blocks, _Prd, _read_source as _mrw_read
        from .io.mrw import BLOCK_PRD, BLOCK_TTW, load_raw_mrw

        data = _mrw_read(args.input)
        out = {"format": "MRW"}
        try:
            blocks, _ = _parse_blocks(data)
            prd = _Prd(blocks[BLOCK_PRD]) if BLOCK_PRD in blocks else None
            if prd is not None:
                out["size"] = [prd.ccd_h, prd.ccd_w]
            ttw = blocks.get(BLOCK_TTW)
            if ttw is not None:
                tf = T.read_tiff(ttw)
                model = tf.ifds[0].get(T.TAG_MODEL) if tf.ifds else None
                if model is not None:
                    out["model"] = (
                        model.as_bytes().split(b"\x00")[0].decode("ascii", "replace")
                    )
            frame = load_raw_mrw(args.input)
            out["as_shot_neutral"] = np.asarray(frame.wb_neutral).tolist()
            out["ev"] = float(frame.ev)
        except ValueError as e:
            out["error"] = str(e)
        print(json.dumps(out, indent=2))
        return 0

    if is_raf(args.input):
        # RAF is a proprietary directory, not a TIFF: report from its
        # embedded TIFF + loader-extracted metadata
        from .io.raf import _read_source, load_raw_raf
        import struct as _struct

        data = _read_source(args.input)
        out = {"format": "RAF"}
        out["model"] = (
            data[0x1C:0x3C].split(b"\x00")[0].decode("ascii", "replace").strip()
        )
        off, ln = _struct.unpack_from(">LL", data, 100)
        try:
            frame = load_raw_raf(args.input)
            out["size"] = list(frame.bayer.shape)
            out["as_shot_neutral"] = np.asarray(frame.wb_neutral).tolist()
            out["ev"] = float(frame.ev)
        except ValueError as e:
            out["error"] = str(e)
            out["ev"] = compute_ev_from_tiff(bytes(data[off : off + ln]))
        print(json.dumps(out, indent=2))
        return 0

    tf = T.read_tiff(args.input)
    out = {}
    if is_cr2(args.input):
        out["format"] = "CR2"
        from .io.cr2 import _find_raw_ifd

        raw = _find_raw_ifd(tf)
    else:
        out["format"] = (
            "NEF" if is_nef(args.input)
            else "ARW" if is_arw(args.input)
            else "RW2" if is_rw2(args.input)
            else "ORF" if is_orf(args.input)
            else "PEF" if is_pef(args.input)
            else "SRW" if is_srw(args.input)
            else "DNG/TIFF"
        )
        raw = tf.find_raw_ifd()
    model = tf.ifds[0].get(T.TAG_MODEL) if tf.ifds else None
    if model is not None:
        out["model"] = model.as_bytes().split(b"\x00")[0].decode("ascii", "replace")
    if raw is not None and raw.get(T.TAG_IMAGE_LENGTH) is not None:
        out["size"] = [
            raw.get(T.TAG_IMAGE_LENGTH).as_ints()[0],
            raw.get(T.TAG_IMAGE_WIDTH).as_ints()[0],
        ]
        cfa = raw.get(T.TAG_CFA_PATTERN)
        if cfa is not None:
            out["cfa"] = list(cfa.as_bytes() if isinstance(cfa.values, bytes)
                              else cfa.as_ints())[:4]
    out["ev"] = compute_ev_from_tiff(args.input)
    active, crop = get_image_area_from_tiff(args.input)
    out["active_area"] = active
    out["crop"] = crop
    try:
        out["as_shot_neutral"] = np.asarray(exif_get_as_shot_neutral(tf)).tolist()
    except KeyError:
        out["as_shot_neutral"] = None
    if out["as_shot_neutral"] is None and out["format"] in ("CR2", "NEF", "ARW", "RW2", "ORF", "PEF", "SRW"):
        # MakerNote formats carry WB outside the DNG EXIF tags; the format
        # loaders extract it — decode (host-side) and report the frame's neutral
        try:
            from .io.raw_loader import load_raw

            out["as_shot_neutral"] = np.asarray(
                load_raw(args.input).wb_neutral
            ).tolist()
        except (ValueError, KeyError):
            pass
    out["n_color_matrices"] = len(exif_get_color_mat_sources(tf))
    out["has_opcode_list_3"] = get_opcode_3_block(args.input) is not None
    print(json.dumps(out, indent=2))
    return 0


def _verify_decode(args) -> int:
    import os

    from .io.verify_decode import (
        BAD_VERDICTS,
        iter_raw_files,
        summary_table,
        sweep_decode,
        verify_decode,
    )

    # directories expand recursively (first-contact sweep: point this at a
    # photo tree the day rawpy + real files exist and read the table)
    sweep = any(os.path.isdir(p) for p in args.inputs)
    if sweep:
        paths = []
        for p in args.inputs:
            paths.extend(iter_raw_files(p) if os.path.isdir(p) else [p])
        reports, summary = sweep_decode(paths)
        for report in reports:
            print(json.dumps(report, separators=(",", ":")))
        print()
        print(summary_table(summary))
        # mismatch AND builtin decode failures flip the exit code — a built-in
        # codec crashing on a file the oracle reads is exactly the bug class
        # this harness exists to catch (intentional rawpy fall-throughs are
        # classified "no-builtin" and stay green)
        return 1 if any(r["verdict"] in BAD_VERDICTS for r in reports) else 0

    any_bad = False
    reports = []
    for path in args.inputs:
        report = verify_decode(path, name=path)
        reports.append(report)
        any_bad |= report["verdict"] in BAD_VERDICTS
    print(json.dumps(reports if len(reports) > 1 else reports[0], indent=2))
    return 1 if any_bad else 0


def _harvest(args) -> int:
    import os

    from .io.camera_matrices import harvest_camera_matrices_from_dng
    from .io.matrix_cache import _read_cache_file, cache_path
    from .io.verify_decode import iter_raw_files

    dng_exts = (".dng", ".tif", ".tiff")
    paths = []
    for p in args.inputs:
        if os.path.isdir(p):
            paths.extend(
                f for f in iter_raw_files(p)
                if os.path.splitext(f)[1].lower() in dng_exts
            )
        else:
            paths.append(p)

    results = []
    harvested_models = set()
    for path in paths:
        row = {"file": path}
        try:
            model, mats = harvest_camera_matrices_from_dng(path, source_name=path)
            row["model"] = model
            row["n_matrices"] = len(mats)
            harvested_models.add(model)
        except (ValueError, KeyError, OSError) as e:
            row["skipped"] = f"{type(e).__name__}: {e}"
        results.append(row)
        print(json.dumps(row, separators=(",", ":")))

    # deltas come back off the persisted cache — the evidence the harvest left
    bodies = _read_cache_file(cache_path())
    for model in sorted(harvested_models):
        deltas = bodies.get(model, {}).get("estimate_vs_real")
        if deltas:
            print(json.dumps({"model": model, "estimate_vs_real": deltas}))
    print(
        f"harvested {len(harvested_models)} bodies from "
        f"{sum('model' in r for r in results)}/{len(results)} files "
        f"-> {cache_path()}"
    )
    return 0 if harvested_models or not paths else 1


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    from .utils.runtime import enable_compile_cache

    enable_compile_cache()
    if args.command == "develop":
        return _develop(args)
    if args.command == "info":
        return _info(args)
    if args.command == "verify-decode":
        return _verify_decode(args)
    if args.command == "harvest":
        return _harvest(args)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
