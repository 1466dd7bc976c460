"""Decode engine top control: NAL dispatch, parameter-set storage and
activation, access-unit boundary detection, picture lifecycle, DPB/POC.

Reference: h264bsd_decoder.c:162 h264bsdDecode, h264bsd_storage.c
(h264bsdStoreSeqParamSet :128, StorePicParamSet :211, ActivateParamSets
:298, CheckAccessUnitBoundary :632).

Architecture (SURVEY.md §7): this host layer drives
  Stage A  bitstream front-end  -> dense per-MB tensors (bitstream/)
  Stage B  pixel backend        -> whole-picture reconstruction (ops/)
  Stage C  frame state          -> DPB / POC / output ordering (core/)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..bitstream import bitreader as br
from ..bitstream.bitreader import BitReader, NalUnit, StreamError
from ..bitstream.frontend import SliceDataError, decode_slice_data
from ..bitstream.mb_layer import MbParser, PictureData
from ..bitstream.params import Pps, Sps, parse_pps, parse_sps
from ..bitstream.slice_group_map import build_slice_group_map
from ..bitstream.slice_header import (I_SLICE, P_SLICE, SliceHeader,
                                      parse_slice_header)
from . import deblock as deblock_mod
from .conceal import conceal_picture, mark_slice_corrupted
from .dpb import Dpb, DpbPicture
from .poc import PocState, decode_poc
from .recon_cpu import Frame, reconstruct_picture


@dataclasses.dataclass
class OutputPicture:
    frame: Frame
    is_idr: bool
    pic_id: int
    num_err_mbs: int
    width: int
    height: int
    crop: Optional[tuple]


# recon_strategy return sentinel: picture consumed, no frame produced
# (collectors/analysis). Returning None instead DECLINES the picture ->
# the built-in backend reconstructs it.
SKIP_RECON = object()


class _AubState:
    """Previous-NAL syntax values for AU boundary detection."""

    def __init__(self) -> None:
        self.first_call = True
        self.prev_frame_num = -1
        self.prev_idr_pic_id = -1
        self.prev_poc_lsb = -1
        self.prev_delta_poc_bottom = 0
        self.prev_delta_poc = [0, 0]
        self.prev_nal_ref_idc = -1
        self.prev_nal_type = -1


class Decoder:
    """Single-stream decode engine. backend="cpu": NumPy reconstruction
    (the golden-validated reference); backend="device": the jitted
    pipeline of core/recon_tpu.py on the default JAX device."""

    def __init__(self, no_reordering: bool = False,
                 backend: str = "cpu", frontend: str = "auto",
                 parallel_slices: int = 0, recon_strategy=None,
                 prefetch_outputs: bool = False,
                 group_frames: int = None,
                 async_pump: bool = None) -> None:
        # frontend: "auto" (native C++ if built), "native", "python"
        # parallel_slices: >1 = parse a picture's slices concurrently on
        # a thread pool (the host analogue of Broadway's sliceMode
        # multi-worker CAVLC, Decoder.js:268-341; the native parser
        # releases the GIL). Slice parsing is deferred to the picture
        # boundary, like the reference's AU-boundary end-of-pic test.
        # recon_strategy: optional callable(decoder, pic) -> frame that
        # replaces the built-in pixel backend for error-free pictures
        # (used by parallel/slices.py band sharding and by tools that
        # only need the parsed tensors). DPB/POC/output bookkeeping is
        # unchanged — only the reconstruction is delegated.
        import os as _os
        env_fe = _os.environ.get("BW_FRONTEND")
        if env_fe:
            frontend = env_fe
        self.frontend = frontend
        self.parallel_slices = parallel_slices
        self.recon_strategy = recon_strategy
        # prefetch_outputs: start the device->host YUV copy as soon as
        # a picture reaches display order, overlapping delivery with
        # the next pictures' decode (the reference's transferable
        # frame post-back, Player/Decoder.js:856-872). Opt-in: host
        # delivery costs link bandwidth that device-resident serving
        # (device YUV->RGB, P4) does not pay.
        self.prefetch_outputs = prefetch_outputs
        # group_frames: decode G consecutive pictures per jit call
        # (recon_tpu.decode_pictures_packed_group) — amortizes
        # per-execution dispatch overhead; outputs become lazy frames
        # that force the group on first pixel access. Default OFF:
        # per-picture dispatch already overlaps host parse/pack with
        # device compute, and waiting to batch G uploads stalls the
        # device. BW_GROUP env overrides.
        if group_frames is None:
            group_frames = int(_os.environ.get("BW_GROUP", "0")) \
                if backend == "device" else 0
        self.group_frames = group_frames
        # async_pump: run upload + jit dispatch for each picture on a
        # dedicated worker thread (in submission order), so a blocking
        # host->device upload or dispatch overlaps the feed thread's
        # parse of the next picture — the reference's worker decode
        # pump (Player.js:140-185) on the host->device axis. Outputs
        # are lazy frames forced on first pixel access.
        if async_pump is None:
            async_pump = backend == "device" \
                and not _os.environ.get("BW_NO_ASYNC") \
                and group_frames <= 1
        self.async_pump = async_pump
        self._pump = None
        self._pump_pend = []
        self._group_pend = []
        self._deferred = []
        self._executor = None
        if parallel_slices > 1:
            from concurrent.futures import ThreadPoolExecutor
            self._executor = ThreadPoolExecutor(parallel_slices)
        self.sps_store: Dict[int, Sps] = {}
        self.pps_store: Dict[int, Pps] = {}
        self.active_sps_id: Optional[int] = None
        self.active_pps_id: Optional[int] = None
        self.sps: Optional[Sps] = None
        self.pps: Optional[Pps] = None
        self.no_reordering = no_reordering
        self.backend = backend
        if backend not in ("cpu", "device"):
            raise ValueError(f"unknown backend {backend!r}")
        if backend == "device":
            # first 1080p compile is slow; make it once per machine
            from ..utils.cache import ensure_compile_cache
            ensure_compile_cache()
        self.dpb: Optional[Dpb] = None
        self.poc_state = PocState()
        self.aub = _AubState()
        self.outputs: List[OutputPicture] = []
        # parsed SEI messages in stream order (bitstream/sei.py)
        self.sei_messages: List[object] = []
        # current picture state
        self.pic: Optional[PictureData] = None
        self.parser: Optional[MbParser] = None
        self.pic_header: Optional[SliceHeader] = None
        self.n_decoded_mbs = 0
        self.slice_count = 0
        self.pic_number = 0
        self.headers_ready = False
        # per-Decode-call concealment policy (H264SwDecApi.h:82-83
        # intraConcealmentMethod): conceal intra pictures from the
        # previous reference instead of gray
        self.intra_conceal_from_ref = False
        # picture of the current AU finished -> later redundant slices
        # are unnecessary (h264bsd_decoder.c:275/475 skipRedundantSlices)
        self.skip_redundant = False

    # ------------------------------------------------------------------
    def decode_annexb(self, data: bytes, flush: bool = True
                      ) -> List[OutputPicture]:
        """Decode a whole Annex-B stream; returns display-order outputs."""
        for _, payload in br.split_nal_units(data):
            try:
                nal = NalUnit(payload)
            except StreamError:
                continue
            self.decode_nal(nal)
        if flush:
            self.flush()
        out, self.outputs = self.outputs, []
        return out

    def flush(self) -> None:
        if self.pic is not None and self._deferred:
            self._run_deferred()
            if self.n_decoded_mbs >= self.pic.n_mbs:
                self._finish_picture(concealed=False)
        if self.pic is not None:
            # INCOMPLETE picture pending at end of stream: the reference
            # drops it — concealment triggers only when the NEXT access
            # unit arrives (h264bsd_decoder.c:236-276), and at EOS
            # DecTestBench just drains the DPB (DecTestBench.c:424), so
            # an errored final picture never reaches the output.
            self.pic, self.pic_header = None, None
            if self.dpb is not None:
                self.dpb.current = None
        self._flush_group()
        if self.dpb is not None:
            self.dpb.flush()
            self._drain()

    def _submit_slice(self, args) -> None:
        """Start parsing one slice on the pool NOW (the native call
        releases the GIL; slices write disjoint MB ranges). Parses run
        while the host keeps scanning NALs / packing earlier pictures —
        the host-side frame pipeline (reference analogue: worker decode
        off the feed thread, Player.js:140-185)."""
        pic, parser, sps, pps = self.pic, self.parser, self.sps, self.pps

        def one():
            from ..bitstream.native import decode_slice_data_native
            rbsp, pos, header, sg_map, slice_id, ref_slots = args
            try:
                decode_slice_data_native(
                    rbsp, pos, pic, parser, header, sps,
                    pps, sg_map, slice_id, ref_slots,
                    append_params=False)
                return None
            except SliceDataError as e:
                return (header, sg_map, slice_id, e)

        self._deferred.append(self._executor.submit(one))

    def _run_deferred(self) -> None:
        """Collect this picture's in-flight slice parses."""
        work, self._deferred = self._deferred, []
        for fut in work:
            res = fut.result()
            if res is not None:
                header, sg_map, slice_id, e = res
                mark_slice_corrupted(self.pic, header.first_mb, sg_map,
                                     slice_id, e.last_mb_addr,
                                     self.sps.width_mbs)
        self.n_decoded_mbs = int(self.pic.decoded.sum())

    # ------------------------------------------------------------------
    def decode_nal(self, nal: NalUnit) -> None:
        t = nal.nal_type
        if t == br.NAL_SPS:
            s = parse_sps(BitReader(nal.rbsp))
            # re-storing a bit-identical SPS keeps the existing object
            # (repeated in-band headers must not look like a sequence
            # change); a CHANGED SPS under the same id replaces it and
            # forces re-activation at the next IDR
            # (h264bsdCompareSeqParamSets, h264bsd_storage.c:128)
            old = self.sps_store.get(s.sps_id)
            if old is None or old != s:
                self.sps_store[s.sps_id] = s
            return
        if t == br.NAL_PPS:
            p = parse_pps(BitReader(nal.rbsp))
            self.pps_store[p.pps_id] = p
            return
        if t in (br.NAL_SLICE, br.NAL_SLICE_IDR):
            self._decode_slice_nal(nal)
            return
        if t == br.NAL_SEI:
            # decode is unaffected by SEI (the reference build skips
            # them outright, h264bsd_decoder.c:480); we additionally
            # parse the messages for application use (recovery points,
            # HRD timing, user data — bitstream/sei.py), tolerating
            # malformed payloads the way the reference tolerates the
            # whole NAL
            try:
                from ..bitstream.sei import parse_sei_rbsp
                self.sei_messages.extend(
                    parse_sei_rbsp(nal.rbsp, self.sps_store))
            except StreamError:
                pass
            return
        if t in (br.NAL_AUD, br.NAL_END_OF_SEQ,
                 br.NAL_END_OF_STREAM, br.NAL_FILLER):
            return  # skipped, like the reference (h264bsd_decoder.c:480)
        # unknown NAL types are skipped

    # ------------------------------------------------------------------
    def _check_au_boundary(self, nal: NalUnit, r: BitReader) -> bool:
        """Peek-parse slice header ids; returns True if this slice starts
        a new access unit (mirrors h264bsdCheckAccessUnitBoundary)."""
        a = self.aub
        new_au = False
        if a.first_call:
            new_au = True
            a.first_call = False
        pos = r.pos
        r.ue()  # first_mb
        r.ue()  # slice_type
        pps_id = r.ue()
        pps = self.pps_store.get(pps_id)
        if pps is None:
            raise StreamError("slice refers to missing PPS")
        sps = self.sps_store.get(pps.sps_id)
        if sps is None:
            raise StreamError("slice refers to missing SPS")
        if (a.prev_nal_ref_idc != nal.ref_idc and
                (a.prev_nal_ref_idc == 0 or nal.ref_idc == 0)):
            new_au = True
        idr = nal.nal_type == br.NAL_SLICE_IDR
        prev_idr = a.prev_nal_type == br.NAL_SLICE_IDR
        if idr != prev_idr:
            new_au = True
        frame_num = r.u((sps.max_frame_num - 1).bit_length())
        if a.prev_frame_num != frame_num:
            a.prev_frame_num = frame_num
            new_au = True
        if idr:
            idr_pic_id = r.ue()
            if prev_idr and a.prev_idr_pic_id != idr_pic_id:
                new_au = True
            a.prev_idr_pic_id = idr_pic_id
        if sps.poc_type == 0:
            lsb = r.u((sps.max_pic_order_cnt_lsb - 1).bit_length())
            if a.prev_poc_lsb != lsb:
                a.prev_poc_lsb = lsb
                new_au = True
            if pps.pic_order_present:
                d = r.se()
                if a.prev_delta_poc_bottom != d:
                    a.prev_delta_poc_bottom = d
                    new_au = True
        elif sps.poc_type == 1 and not sps.delta_pic_order_always_zero:
            d0 = r.se()
            if a.prev_delta_poc[0] != d0:
                a.prev_delta_poc[0] = d0
                new_au = True
            if pps.pic_order_present:
                d1 = r.se()
                if a.prev_delta_poc[1] != d1:
                    a.prev_delta_poc[1] = d1
                    new_au = True
        a.prev_nal_ref_idc = nal.ref_idc
        a.prev_nal_type = nal.nal_type
        r.pos = pos
        return new_au

    # ------------------------------------------------------------------
    def _activate(self, pps_id: int, is_idr: bool) -> None:
        pps = self.pps_store.get(pps_id)
        if pps is None:
            raise StreamError("activation of missing PPS")
        sps = self.sps_store.get(pps.sps_id)
        if sps is None:
            raise StreamError("activation of missing SPS")
        if self.active_sps_id != sps.sps_id or self.sps is not sps:
            # id switch OR content redefinition under the same id
            if self.sps is not None and not is_idr:
                raise StreamError("SPS change on non-IDR picture")
            # emit the previous sequence's buffered pictures before the
            # DPB is re-allocated (the reference outputs prior pics at
            # the IDR boundary: h264bsd_decoder.c:369-399 prior-pics
            # flush; SoftAVC drains output before reconfiguring ports)
            if getattr(self, "dpb", None) is not None:
                self.dpb.flush()
                self._drain()
            # (re)allocate DPB for the new sequence
            self.dpb = Dpb(sps.dpb_size(), max(sps.num_ref_frames, 1),
                           sps.max_frame_num, self.no_reordering)
            self.poc_state = PocState()
            self.active_sps_id = sps.sps_id
            self.headers_ready = True
        self.active_pps_id = pps_id
        self.sps = sps
        self.pps = pps

    # ------------------------------------------------------------------
    def _decode_slice_nal(self, nal: NalUnit) -> None:
        nal_rbsp = nal.rbsp
        r = BitReader(nal.rbsp)
        new_au = self._check_au_boundary(nal, r)
        if new_au:
            self.skip_redundant = False
            if self.pic is not None:
                if self._deferred:
                    self._run_deferred()
                self._finish_picture(concealed=True)

        # activation happens on the first slice of the picture
        pos = r.pos
        r.ue()
        r.ue()
        pps_id = r.ue()
        r.pos = pos
        if self.pic is None:
            self._activate(pps_id, nal.nal_type == br.NAL_SLICE_IDR)
        elif pps_id != self.active_pps_id:
            self._activate(pps_id, nal.nal_type == br.NAL_SLICE_IDR)

        header = parse_slice_header(r, nal.nal_type, nal.ref_idc,
                                    self.sps, self.pps)

        if header.redundant_pic_cnt and (self.pic is not None
                                         or self.skip_redundant):
            # primary picture present (or already finished) in this AU
            # -> redundant slice is not needed (h264bsd_decoder.c:319
            # skipRedundantSlices / slice_data decoded-flag dedup). Only
            # when the primary was lost entirely does the redundant
            # slice decode below as the fallback picture.
            return

        if self.pic is None:
            self._start_picture(header)

        # reference picture list for this slice
        ref_slots: List[int] = []
        if header.slice_type == P_SLICE:
            self.dpb.init_ref_pic_list()
            self.dpb.reorder_ref_pic_list(header.ref_list_mods,
                                          header.frame_num,
                                          header.num_ref_idx_l0)
            for i in range(header.num_ref_idx_l0):
                p = self.dpb.list[i]
                if p is None:
                    raise StreamError("ref list shorter than active refs")
                # non-existing (frame-gap) refs: any MB using them errors
                # like the reference's NULL refAddr (concealment path)
                ref_slots.append(-2 if p.non_existing else p.slot)

        sg_map = build_slice_group_map(self.sps, self.pps,
                                       header.slice_group_change_cycle)
        slice_id = self.slice_count
        self.slice_count += 1
        self.last_header = header
        try:
            use_native = self.frontend != "python"
            if use_native:
                from ..bitstream import native as nat
                if self.frontend == "auto" and not nat.available():
                    use_native = False
            if use_native and self._executor is not None:
                from ..bitstream.native import append_slice_params
                append_slice_params(self.pic, header, slice_id, ref_slots)
                self._submit_slice((nal_rbsp, r.pos, header, sg_map,
                                    slice_id, ref_slots))
                return        # collected at the picture boundary
            elif use_native:
                from ..bitstream.native import decode_slice_data_native
                decode_slice_data_native(nal_rbsp, r.pos, self.pic,
                                         self.parser, header, self.sps,
                                         self.pps, sg_map, slice_id,
                                         ref_slots)
            else:
                decode_slice_data(r, self.pic, self.parser, header,
                                  self.sps, self.pps, sg_map, slice_id,
                                  ref_slots)
        except SliceDataError as e:
            # corrupt slice: un-decode its MBs; concealment happens when
            # the picture boundary is detected (h264bsd_decoder.c:236-276)
            mark_slice_corrupted(self.pic, header.first_mb, sg_map,
                                 slice_id, e.last_mb_addr,
                                 self.sps.width_mbs)
            self.pic_has_errors = True
        self.n_decoded_mbs = int(self.pic.decoded.sum())

        if self.n_decoded_mbs >= self.pic.n_mbs:
            self._finish_picture(concealed=False)

    # ------------------------------------------------------------------
    def _start_picture(self, header: SliceHeader) -> None:
        sps = self.sps
        self.pic = PictureData(sps.width_mbs, sps.height_mbs)
        self.parser = MbParser(self.pic, self.pps.constrained_intra_pred)
        self.pic_header = header
        self.n_decoded_mbs = 0
        self.slice_count = 0
        if not header.idr:
            self.dpb.check_gaps_in_frame_num(
                header.frame_num, sps.gaps_in_frame_num_allowed)
        self.dpb.allocate_picture()

    def _finish_picture(self, concealed: bool) -> None:
        pic, header = self.pic, self.pic_header
        sps, pps = self.sps, self.pps
        self.pic, self.pic_header = None, None
        self.skip_redundant = True

        num_err = pic.n_mbs - int(pic.decoded.sum())
        frame = None
        skipped = False
        if num_err:
            frame = self._reconstruct_concealed(pic, num_err)
            num_err = int(pic.concealed.sum())
        elif self.recon_strategy is not None:
            # a strategy may decline a picture (returns None) -> fall
            # back to the built-in backend below; SKIP_RECON = consumed
            frame = self.recon_strategy(self, pic)
            if frame is SKIP_RECON:
                frame, skipped = None, True
        if frame is not None or skipped:
            pass
        elif self.backend == "device":
            frame = self._reconstruct_device(pic)
        else:
            ref_frames = {p.slot: p.frame for p in self.dpb.buffer
                          if p.frame is not None}
            frame = reconstruct_picture(pic, pps.chroma_qp_index_offset,
                                        pps.constrained_intra_pred,
                                        ref_frames, sps.width, sps.height)
            # in-loop deblocking
            deblock_mod.filter_picture(frame, pic,
                                       pps.chroma_qp_index_offset)

        cur_mmco5 = any(m.op == 5 for m in header.mmco)
        poc = decode_poc(sps, header, self.poc_state, header.nal_ref_idc,
                         cur_mmco5)
        if cur_mmco5:
            poc = 0

        self.dpb.current.frame = frame
        self.dpb.current.width = sps.width
        self.dpb.current.height = sps.height
        self.dpb.current.crop = sps.crop
        self.dpb.mark_decoded_ref_pic(
            is_ref=header.nal_ref_idc != 0,
            mmco=header.mmco,
            adaptive=header.adaptive_ref_pic_marking,
            frame_num=header.frame_num,
            poc=poc,
            is_idr=header.idr,
            no_output_of_prior=header.no_output_of_prior_pics,
            long_term_ref=header.long_term_reference,
            pic_id=self.pic_number,
            num_err_mbs=num_err)
        self.pic_number += 1
        self.dpb.prev_ref_frame_num = header.frame_num \
            if header.nal_ref_idc else self.dpb.prev_ref_frame_num
        self._drain()

    def _cpu_frame(self, f):
        if f is None or isinstance(f, Frame):
            return f
        import numpy as np
        nf = Frame.__new__(Frame)
        nf.y = np.asarray(f.y).astype(np.uint8)
        nf.cb = np.asarray(f.cb).astype(np.uint8)
        nf.cr = np.asarray(f.cr).astype(np.uint8)
        return nf

    def _pump_submit(self, job) -> None:
        """Queue an upload+dispatch closure on the single pump worker
        (strict submission order — the donated device DPB stack chain
        is threaded through the jobs)."""
        if self._pump is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pump = ThreadPoolExecutor(
                1, thread_name_prefix="bw-pump")
        # prune completed jobs, PROPAGATING any stored exception — a
        # silently dropped failure would leave later frames decoding
        # against stale reference stacks
        keep = []
        for f in self._pump_pend:
            if f.done():
                f.result()
            else:
                keep.append(f)
        self._pump_pend = keep
        self._pump_pend.append(self._pump.submit(job))

    def _pump_flush(self) -> None:
        """Drain the dispatch pump: after this, no worker job touches
        the device stacks, so the main thread may read/rebuild them."""
        pend, self._pump_pend = self._pump_pend, []
        for f in pend:
            f.result()

    def close(self) -> None:
        """Release worker threads (pump + slice pool). The decoder
        remains unusable for further decode calls after this."""
        try:
            self._pump_flush()
        finally:
            if self._pump is not None:
                self._pump.shutdown(wait=True)
                self._pump = None
            if self._executor is not None:
                self._executor.shutdown(wait=True)
                self._executor = None

    def _flush_group(self) -> None:
        """Drain the dispatch pump, then run the pending frame-group
        jit and materialize its lazy frames (no-op when nothing is
        pending). This is the universal sync point before any main-
        thread access to the device DPB stacks."""
        self._pump_flush()
        pend, self._group_pend = self._group_pend, []
        if not pend:
            return
        import jax
        import numpy as np

        from . import packed as PK
        from . import recon_tpu as RT

        lay, ci, co, steps = pend[0]["cfg"]
        G = len(pend)
        if G == 1:
            p = pend[0]
            y, cb, cr, yuv, self._stack_y, self._stack_c = \
                RT.decode_picture_packed2(
                    jax.device_put(p["buf"]), self._stack_y,
                    self._stack_c, p["slot"], steps, lay=lay,
                    bk=p["bk"], constrained_intra=ci,
                    chroma_qp_offset=co)
            p["frame"]._set(y, cb, cr, yuv)
            return
        BK = tuple(max(p["bk"][j] for p in pend) for j in range(3))
        bufs = np.stack([PK.expand_buf_v2(p["buf"], lay, p["bk"], BK)
                         for p in pend])
        slots = np.array([p["slot"] for p in pend], np.int32)
        ys, cbs, crs, yuvs, self._stack_y, self._stack_c = \
            RT.decode_pictures_packed_group(
                jax.device_put(bufs), self._stack_y, self._stack_c,
                jax.device_put(slots), steps, lay=lay, bk=BK,
                constrained_intra=ci, chroma_qp_offset=co, group=G)
        for g, p in enumerate(pend):
            p["frame"]._set(ys[g], cbs[g], crs[g], yuvs[g])

    def _reconstruct_concealed(self, pic: PictureData, num_err: int):
        """Error path: CPU reconstruction of the decoded MBs, then
        concealment + deblocking (h264bsdConceal semantics)."""
        self._flush_group()   # refs must be materialized/current
        sps, pps = self.sps, self.pps
        ref_frames = {p.slot: self._cpu_frame(p.frame)
                      for p in self.dpb.buffer
                      if p.frame is not None}
        frame = reconstruct_picture(pic, pps.chroma_qp_index_offset,
                                    pps.constrained_intra_pred, ref_frames,
                                    sps.width, sps.height)
        # lowest-index reference for whole/inter concealment; the
        # reference's list is freshly initialized for every slice
        # (h264bsd_decoder.c:256/445), so rebuild it here
        self.dpb.init_ref_pic_list()
        ref0 = None
        for i in range(16):
            f = self.dpb.ref_frame(i)
            if f is not None:
                ref0 = self._cpu_frame(f)
                break
        stype = self.last_header.slice_type if \
            getattr(self, "last_header", None) else I_SLICE
        conceal_picture(pic, frame, stype, ref0,
                        self.intra_conceal_from_ref)
        deblock_mod.filter_picture(frame, pic, pps.chroma_qp_index_offset)
        if self.backend == "device":
            import jax.numpy as jnp

            from . import recon_tpu as RT
            y = jnp.asarray(frame.y.astype("int32"))
            cb = jnp.asarray(frame.cb.astype("int32"))
            cr = jnp.asarray(frame.cr.astype("int32"))
            if getattr(self, "_dstack_key", None) is not None:
                # packed fast path active: keep device stacks coherent
                self._stack_y, self._stack_c = RT.update_stack_slot(
                    self._stack_y, self._stack_c,
                    self.dpb.current.slot, y, cb, cr)
                frame = RT.DeviceFrame(y, cb, cr, pad=False)
            else:
                frame = RT.DeviceFrame(y, cb, cr)
        return frame

    def _ensure_stacks(self) -> None:
        """(Re)create the persistent device ref-plane stacks for the
        active sequence, seeding from any DPB frames already present
        (load_state / concealed-first-picture paths)."""
        import jax.numpy as jnp

        from . import recon_tpu as RT
        from ..ops.tpu import inter as K_mc

        sps = self.sps
        R = self.dpb.dpb_size + 1
        key = (sps.width_mbs, sps.height_mbs, R)
        if getattr(self, "_dstack_key", None) == key:
            return
        self._flush_group()   # old-geometry group must run first
        hy, wy = K_mc.luma_ext_dims(sps.width, sps.height)
        hc, wc = K_mc.chroma_ext_dims(sps.width, sps.height)
        self._stack_y = jnp.zeros((R, hy, wy), jnp.int32)
        self._stack_c = jnp.zeros((R, hc, wc), jnp.int32)
        self._dstack_key = key
        for p in self.dpb.buffer:
            if p.frame is not None and not p.non_existing \
                    and p is not self.dpb.current:
                self._stack_y, self._stack_c = RT.update_stack_slot(
                    self._stack_y, self._stack_c, p.slot,
                    p.frame.y, p.frame.cb, p.frame.cr)

    def _reconstruct_device(self, pic: PictureData):
        """Whole-picture reconstruction on the jitted device pipeline
        (core/recon_tpu.py)."""
        import os

        import jax
        import jax.numpy as jnp

        from . import recon_tpu as RT

        sps, pps = self.sps, self.pps
        w, h = sps.width_mbs, sps.height_mbs
        key = (w, h)
        if getattr(self, "_steps_key", None) != key:
            self._flush_group()
            self._steps = {k: jnp.asarray(v)
                           for k, v in RT.step_tables(w, h).items()}
            self._steps_key = key

        from ..bitstream import native as nat
        if nat.pack2_available() and not os.environ.get("BW_NO_PACK") \
                and not os.environ.get("BW_PACK_V1"):
            # fastest path: ONE COMPACT upload (v2, ~13 B/MB + sparse
            # rows), persistent device DPB stacks updated in place
            # inside a single jit call per picture; output delivered as
            # a single u8 YUV buffer
            from . import packed as PK
            lay = PK.get_packed_layout_v2(w, h)
            if getattr(self, "_pack2_scratch", None) is None or \
                    self._pack2_scratch.lay is not lay:
                self._pack2_scratch = PK.PackScratchV2(lay)
            res = PK.pack_picture_v2(pic, lay, self._pack2_scratch)
            if res is not None:
                self._ensure_stacks()
                buf, bk = res
                slot = self.dpb.current.slot
                if self.group_frames > 1:
                    # frame-group fast path: queue; the jit runs when
                    # the group fills (or on any forcing access)
                    fr = RT.LazyDeviceFrame(self._flush_group)
                    self._group_pend.append({
                        "buf": buf, "bk": bk, "slot": slot,
                        "frame": fr,
                        "cfg": (lay, pps.constrained_intra_pred,
                                pps.chroma_qp_index_offset,
                                self._steps)})
                    if len(self._group_pend) >= self.group_frames:
                        self._flush_group()
                    return fr
                ci = pps.constrained_intra_pred
                co = pps.chroma_qp_index_offset
                if self.async_pump:
                    # upload + dispatch on the pump worker: the H2D
                    # block rides the worker while this (feed) thread
                    # parses the next picture's slices
                    fr = RT.LazyDeviceFrame(self._pump_flush)
                    steps = self._steps

                    def job(buf=buf, bk=bk, slot=slot, lay=lay,
                            steps=steps, ci=ci, co=co, fr=fr):
                        y, cb, cr, yuv, self._stack_y, self._stack_c = \
                            RT.decode_picture_packed2(
                                jax.device_put(buf), self._stack_y,
                                self._stack_c, slot, steps, lay=lay,
                                bk=bk, constrained_intra=ci,
                                chroma_qp_offset=co)
                        fr._set(y, cb, cr, yuv)

                    self._pump_submit(job)
                    return fr
                dbuf = jax.device_put(buf)
                y, cb, cr, yuv, self._stack_y, self._stack_c = \
                    RT.decode_picture_packed2(
                        dbuf, self._stack_y, self._stack_c, slot,
                        self._steps, lay=lay, bk=bk,
                        constrained_intra=ci,
                        chroma_qp_offset=co)
                return RT.DeviceFrame(y, cb, cr, pad=False, yuv_u8=yuv)

        if nat.pack_available() and not os.environ.get("BW_NO_PACK"):
            # fast path: ONE packed upload, persistent device DPB stacks
            # updated in place inside a single jit call per picture
            self._flush_group()   # keep stack-update order
            from . import packed as PK
            lay = PK.get_packed_layout(w, h)
            if getattr(self, "_pack_scratch", None) is None or \
                    self._pack_scratch.lay is not lay:
                self._pack_scratch = PK.PackScratch(lay)
            self._ensure_stacks()
            buf, kb = PK.pack_picture(pic, lay, self._pack_scratch)
            dbuf = jax.device_put(buf)
            slot = self.dpb.current.slot
            y, cb, cr, self._stack_y, self._stack_c = \
                RT.decode_picture_packed(
                    dbuf, self._stack_y, self._stack_c, slot, self._steps,
                    lay=lay, kb=kb,
                    constrained_intra=pps.constrained_intra_pred,
                    chroma_qp_offset=pps.chroma_qp_index_offset)
            return RT.DeviceFrame(y, cb, cr, pad=False)

        self._flush_group()
        arrs = RT.host_picture_arrays(pic, pps.chroma_qp_index_offset,
                                      pps.constrained_intra_pred)
        arrs = {k: jnp.asarray(v) for k, v in arrs.items()}

        ref_y, ref_c = RT.ref_stacks(self.dpb.buffer, sps.width,
                                     sps.height)
        y, cb, cr = RT.decode_picture(
            arrs, ref_y, ref_c, self._steps,
            w_mbs=w, h_mbs=h,
            chroma_qp_offset=pps.chroma_qp_index_offset)
        return RT.DeviceFrame(y, cb, cr)

    def _drain(self) -> None:
        for p in self.dpb.drain_outputs():
            if self.prefetch_outputs and p.frame is not None:
                f = getattr(p.frame, "start_fetch", None)
                if f is not None:
                    f()
            self.outputs.append(OutputPicture(
                frame=p.frame, is_idr=p.is_idr, pic_id=p.pic_id,
                num_err_mbs=p.num_err_mbs,
                width=p.width or self.sps.width,
                height=p.height or self.sps.height,
                crop=p.crop if p.crop is not None else self.sps.crop))

    # ------------------------------------------------------------------
    # Checkpoint / resume (SURVEY.md §5): decoder state = parameter-set
    # stores + DPB frames + POC state at a picture boundary. IDR frames
    # are the natural resume points (DPB flush semantics), but any
    # inter-picture boundary checkpoint restores exactly.
    def save_state(self) -> dict:
        """Snapshot the decode state (host-resident, pickle-able)."""
        self._flush_group()
        import copy

        import numpy as _np

        def planes(f):
            if f is None:
                return None
            return (_np.asarray(f.y).astype(_np.uint8),
                    _np.asarray(f.cb).astype(_np.uint8),
                    _np.asarray(f.cr).astype(_np.uint8))

        st = {
            "sps_store": copy.deepcopy(self.sps_store),
            "pps_store": copy.deepcopy(self.pps_store),
            "active": (self.active_sps_id, self.active_pps_id),
            "poc_state": copy.deepcopy(self.poc_state),
            "aub": copy.deepcopy(self.aub),
            "pic_number": self.pic_number,
            "headers_ready": self.headers_ready,
            "dpb": None,
        }
        d = self.dpb
        if d is not None:
            pics = []
            for p in d.buffer:
                f = {k: getattr(p, k) for k in
                     ("status", "frame_num", "pic_num", "poc",
                      "to_be_displayed", "is_idr", "pic_id",
                      "num_err_mbs", "non_existing", "slot")}
                f["planes"] = planes(p.frame)
                pics.append(f)
            idx = {id(p): i for i, p in enumerate(d.buffer)}
            st["dpb"] = {
                "ctor": (d.dpb_size, d.max_ref_frames, d.max_frame_num,
                         d.no_reordering),
                "fullness": d.fullness,
                "num_ref_frames": d.num_ref_frames,
                "prev_ref_frame_num": d.prev_ref_frame_num,
                "last_contains_mmco5": d.last_contains_mmco5,
                "max_long_term_frame_idx": d.max_long_term_frame_idx,
                "buffer": pics,
                "out": [idx[id(p)] for p in d.out],
                "current": idx.get(id(d.current), None),
            }
        return st

    def load_state(self, st: dict) -> None:
        """Restore a save_state() snapshot (backend frames rebuilt)."""
        from .dpb import Dpb, DpbPicture

        self.sps_store = st["sps_store"]
        self.pps_store = st["pps_store"]
        self.active_sps_id, self.active_pps_id = st["active"]
        self.sps = (self.sps_store.get(self.active_sps_id)
                    if self.active_sps_id is not None else None)
        self.pps = (self.pps_store.get(self.active_pps_id)
                    if self.active_pps_id is not None else None)
        self.poc_state = st["poc_state"]
        self.aub = st["aub"]
        self.pic_number = st["pic_number"]
        self.headers_ready = st["headers_ready"]
        self.outputs = []
        self.pic = self.pic_header = None
        self._dstack_key = None       # device stacks rebuilt on demand
        sd = st["dpb"]
        if sd is None:
            self.dpb = None
            return
        dpb_size, max_ref, max_fn, no_reorder = sd["ctor"]
        d = Dpb.__new__(Dpb)
        d.max_ref_frames = max_ref
        d.dpb_size = dpb_size
        d.max_frame_num = max_fn
        d.no_reordering = no_reorder
        d.fullness = sd["fullness"]
        d.num_ref_frames = sd["num_ref_frames"]
        d.prev_ref_frame_num = sd["prev_ref_frame_num"]
        d.last_contains_mmco5 = sd["last_contains_mmco5"]
        d.max_long_term_frame_idx = sd["max_long_term_frame_idx"]
        d.buffer = []
        for f in sd["buffer"]:
            p = DpbPicture(**{k: v for k, v in f.items()
                              if k != "planes"})
            if f["planes"] is not None:
                y, cb, cr = f["planes"]
                if self.backend == "device":
                    import jax.numpy as jnp

                    from .recon_tpu import DeviceFrame
                    p.frame = DeviceFrame(jnp.asarray(y.astype("int32")),
                                          jnp.asarray(cb.astype("int32")),
                                          jnp.asarray(cr.astype("int32")))
                else:
                    fr = Frame.__new__(Frame)
                    fr.y, fr.cb, fr.cr = y, cb, cr
                    p.frame = fr
            d.buffer.append(p)
        if any(p.slot < 0 for p in d.buffer):   # pre-slot checkpoints
            for i, p in enumerate(d.buffer):
                p.slot = i
        d.list = [None] * 33
        d.out = [d.buffer[i] for i in sd["out"]]
        d.current = (d.buffer[sd["current"]]
                     if sd["current"] is not None else None)
        self.dpb = d
