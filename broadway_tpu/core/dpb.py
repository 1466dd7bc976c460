"""Decoded picture buffer — mirrors the reference's model exactly
(h264bsd_dpb.c): dpbSize+1 frame stores kept sorted by ComparePictures
:138 (short-term by picNum desc, long-term by picNum asc, then
to-be-displayed, then free), init ref list = sorted prefix
(h264bsdInitRefPicList :1104), explicit reordering :224, MMCO ops :321-546,
sliding window :909, output = smallest-POC to-be-displayed picture when
fullness exceeds dpbSize (:1380-1460), flush :1500.

Note: frames are whatever array type the backend produces (NumPy here,
device-resident jax.Array in the device backend — the DPB is index/metadata
bookkeeping only and never touches pixel data).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..bitstream.slice_header import MmcoOp, RefPicListMod

UNUSED, SHORT_TERM, LONG_TERM = 0, 1, 2


@dataclasses.dataclass
class DpbPicture:
    frame: object = None            # backend frame (owned elsewhere)
    status: int = UNUSED
    frame_num: int = 0
    pic_num: int = 0
    poc: int = 0
    to_be_displayed: bool = False
    is_idr: bool = False
    pic_id: int = 0
    num_err_mbs: int = 0
    non_existing: bool = False
    # display geometry captured at decode time: a mid-stream SPS change
    # (new resolution at IDR) must not relabel pictures of the previous
    # sequence that are still queued for output (SoftAVC port-settings
    # semantics, SoftAVC.cpp:536)
    width: int = 0
    height: int = 0
    crop: object = None
    # stable frame-store index: survives the buffer-order sorts and maps
    # this store to its row in the device-resident ref-plane stacks
    slot: int = -1

    @property
    def is_ref(self) -> bool:
        return self.status != UNUSED

    def _cmp_key(self):
        # Sort key replicating ComparePictures: smaller key sorts first.
        if self.status == SHORT_TERM:
            return (0, -self.pic_num)
        if self.status == LONG_TERM:
            return (1, self.pic_num)
        if self.to_be_displayed:
            return (2, 0)
        return (3, 0)


class DpbError(Exception):
    pass


class Dpb:
    def __init__(self, dpb_size: int, max_ref_frames: int,
                 max_frame_num: int, no_reordering: bool = False) -> None:
        self.max_ref_frames = max(max_ref_frames, 1)
        self.dpb_size = self.max_ref_frames if no_reordering else dpb_size
        self.max_frame_num = max_frame_num
        self.no_reordering = no_reordering
        self.buffer: List[DpbPicture] = [DpbPicture(slot=i)
                                         for i in range(self.dpb_size + 1)]
        self.list: List[Optional[DpbPicture]] = [None] * 33
        self.out: List[DpbPicture] = []   # display-order output queue
        self.fullness = 0
        self.num_ref_frames = 0
        self.prev_ref_frame_num = 0
        self.last_contains_mmco5 = False
        self.max_long_term_frame_idx = -1  # NO_LONG_TERM_FRAME_INDICES
        self.current: Optional[DpbPicture] = None

    # ------------------------------------------------------------------
    def _sort(self) -> None:
        self.buffer.sort(key=lambda p: p._cmp_key())

    def allocate_picture(self) -> DpbPicture:
        """Reserve the free slot (buffer[dpb_size]) for the picture being
        decoded (h264bsdAllocateDpbImage :877)."""
        cur = self.buffer[self.dpb_size]
        assert not cur.to_be_displayed and not cur.is_ref
        cur.__init__(slot=cur.slot)
        self.current = cur
        return cur

    def _set_pic_nums(self, curr_frame_num: int) -> None:
        for p in self.buffer:
            if p.status == SHORT_TERM:
                if p.frame_num > curr_frame_num:
                    p.pic_num = p.frame_num - self.max_frame_num
                else:
                    p.pic_num = p.frame_num

    # ------------------------------------------------------------------
    # reference picture list
    # ------------------------------------------------------------------

    def init_ref_pic_list(self) -> None:
        for i in range(33):
            self.list[i] = None
        for i in range(self.num_ref_frames):
            self.list[i] = self.buffer[i]

    def reorder_ref_pic_list(self, mods: Optional[List[RefPicListMod]],
                             curr_frame_num: int,
                             num_ref_idx_active: int) -> None:
        self._set_pic_nums(curr_frame_num)
        if not mods:
            return
        ref_idx = 0
        pic_num_pred = curr_frame_num
        for m in mods:
            if m.op < 2:
                if m.op == 0:
                    no_wrap = pic_num_pred - (m.value + 1)
                    if no_wrap < 0:
                        no_wrap += self.max_frame_num
                else:
                    no_wrap = pic_num_pred + (m.value + 1)
                    if no_wrap >= self.max_frame_num:
                        no_wrap -= self.max_frame_num
                pic_num_pred = no_wrap
                pic_num = no_wrap
                if no_wrap > curr_frame_num:
                    pic_num -= self.max_frame_num
                short = True
            else:
                pic_num = m.value
                short = False
            idx = self._find_pic(pic_num, short)
            if idx is None or self.buffer[idx].non_existing:
                raise DpbError("reordering refers to missing picture")
            for j in range(num_ref_idx_active, ref_idx, -1):
                self.list[j] = self.list[j - 1]
            self.list[ref_idx] = self.buffer[idx]
            ref_idx += 1
            # remove later duplicates
            k = ref_idx
            for j in range(ref_idx, num_ref_idx_active + 1):
                if self.list[j] is not self.buffer[idx]:
                    self.list[k] = self.list[j]
                    k += 1
            for j in range(k, num_ref_idx_active + 1):
                self.list[j] = None

    def _find_pic(self, pic_num: int, short: bool) -> Optional[int]:
        for i, p in enumerate(self.buffer):
            if short and p.status == SHORT_TERM and p.pic_num == pic_num:
                return i
            if not short and p.status == LONG_TERM and p.pic_num == pic_num:
                return i
        return None

    def ref_frame(self, index: int):
        p = self.list[index] if index <= 16 else None
        if p is None or p.non_existing:
            return None
        return p.frame

    # ------------------------------------------------------------------
    # marking
    # ------------------------------------------------------------------

    def _output_picture(self) -> bool:
        if self.no_reordering:
            return False
        cand = None
        for p in self.buffer:
            if p.to_be_displayed and (cand is None or p.poc < cand.poc):
                cand = p
        if cand is None:
            return False
        self.out.append(cand)
        cand.to_be_displayed = False
        if not cand.is_ref:
            self.fullness -= 1
        return True

    def _mmcop5(self) -> None:
        for p in self.buffer:
            if p.is_ref:
                p.status = UNUSED
                if not p.to_be_displayed:
                    self.fullness -= 1
        while self._output_picture():
            pass
        self.num_ref_frames = 0
        self.max_long_term_frame_idx = -1
        self.prev_ref_frame_num = 0

    def _sliding_window(self) -> None:
        if self.num_ref_frames < self.max_ref_frames:
            return
        idx, pic_num = None, 0
        for i, p in enumerate(self.buffer):
            if p.status == SHORT_TERM:
                if idx is None or p.pic_num < pic_num:
                    idx, pic_num = i, p.pic_num
        if idx is None:
            raise DpbError("sliding window: no short-term picture")
        p = self.buffer[idx]
        p.status = UNUSED
        self.num_ref_frames -= 1
        if not p.to_be_displayed:
            self.fullness -= 1

    def _mmcop1(self, curr_pic_num: int, diff: int) -> None:
        pic_num = curr_pic_num - diff
        idx = self._find_pic(pic_num, True)
        if idx is None:
            raise DpbError("MMCO1: picture not found")
        p = self.buffer[idx]
        p.status = UNUSED
        self.num_ref_frames -= 1
        if not p.to_be_displayed:
            self.fullness -= 1

    def _mmcop2(self, long_term_pic_num: int) -> None:
        idx = self._find_pic(long_term_pic_num, False)
        if idx is None:
            raise DpbError("MMCO2: picture not found")
        p = self.buffer[idx]
        p.status = UNUSED
        self.num_ref_frames -= 1
        if not p.to_be_displayed:
            self.fullness -= 1

    def _mmcop3(self, curr_pic_num: int, diff: int, lt_idx: int) -> None:
        if self.max_long_term_frame_idx == -1 or \
                lt_idx > self.max_long_term_frame_idx:
            raise DpbError("MMCO3: invalid longTermFrameIdx")
        idx = self._find_pic(curr_pic_num - diff, True)
        if idx is None:
            raise DpbError("MMCO3: picture not found")
        # remove existing long-term with the same index
        for p in self.buffer:
            if p.status == LONG_TERM and p.pic_num == lt_idx:
                p.status = UNUSED
                self.num_ref_frames -= 1
                if not p.to_be_displayed:
                    self.fullness -= 1
                break
        p = self.buffer[idx]
        p.status = LONG_TERM
        p.pic_num = lt_idx

    def _mmcop6(self, frame_num: int, poc: int, lt_idx: int) -> bool:
        if self.max_long_term_frame_idx == -1 or \
                lt_idx > self.max_long_term_frame_idx:
            raise DpbError("MMCO6: invalid longTermFrameIdx")
        for p in self.buffer:
            if p.status == LONG_TERM and p.pic_num == lt_idx:
                p.status = UNUSED
                self.num_ref_frames -= 1
                if not p.to_be_displayed:
                    self.fullness -= 1
                break
        if self.num_ref_frames >= self.max_ref_frames:
            raise DpbError("MMCO6: no room")
        cur = self.current
        cur.frame_num = frame_num
        cur.pic_num = lt_idx
        cur.poc = poc
        cur.status = LONG_TERM
        cur.to_be_displayed = not self.no_reordering
        self.num_ref_frames += 1
        self.fullness += 1
        return True

    def check_gaps_in_frame_num(self, frame_num: int,
                                gaps_allowed: bool) -> None:
        """h264bsdCheckGapsInFrameNum :1244 — synthesize non-existing
        short-term frames for skipped frame_num values."""
        if not gaps_allowed:
            return
        if frame_num == self.prev_ref_frame_num or \
                frame_num == (self.prev_ref_frame_num + 1) % \
                self.max_frame_num:
            return
        unused = (self.prev_ref_frame_num + 1) % self.max_frame_num
        while unused != frame_num:
            self._set_pic_nums(unused)
            self._sliding_window()
            while self.fullness >= self.dpb_size:
                if not self._output_picture():
                    break
            slot = self.buffer[self.dpb_size]
            assert not slot.to_be_displayed and not slot.is_ref
            slot.__init__(slot=slot.slot)
            slot.status = SHORT_TERM
            slot.non_existing = True
            slot.frame_num = unused
            slot.pic_num = unused
            slot.poc = 0
            self.fullness += 1
            self.num_ref_frames += 1
            self._sort()
            unused = (unused + 1) % self.max_frame_num

    def _mmcop4(self, max_lt_idx: int) -> None:
        self.max_long_term_frame_idx = max_lt_idx
        for p in self.buffer:
            if p.status == LONG_TERM and p.pic_num > max_lt_idx:
                p.status = UNUSED
                self.num_ref_frames -= 1
                if not p.to_be_displayed:
                    self.fullness -= 1

    def mark_decoded_ref_pic(self, is_ref: bool, mmco: List[MmcoOp],
                             adaptive: bool, frame_num: int, poc: int,
                             is_idr: bool, no_output_of_prior: bool,
                             long_term_ref: bool, pic_id: int,
                             num_err_mbs: int = 0) -> None:
        """h264bsdMarkDecRefPic :628 — finalize the current picture."""
        cur = self.current
        self.last_contains_mmco5 = False
        to_be_displayed = not self.no_reordering

        if not is_ref:
            cur.status = UNUSED
            cur.frame_num = frame_num
            cur.pic_num = frame_num
            cur.poc = poc
            cur.to_be_displayed = to_be_displayed
            if not self.no_reordering:
                self.fullness += 1
        elif is_idr:
            self.out.clear()
            self._mmcop5()
            if no_output_of_prior or self.no_reordering:
                self.out.clear()
            cur.status = LONG_TERM if long_term_ref else SHORT_TERM
            self.max_long_term_frame_idx = 0 if long_term_ref else -1
            cur.frame_num = 0
            cur.pic_num = 0
            cur.poc = 0
            cur.to_be_displayed = to_be_displayed
            self.fullness = 1
            self.num_ref_frames = 1
        else:
            marked_long = False
            if adaptive:
                for m in mmco:
                    if m.op == 1:
                        self._mmcop1(frame_num, m.val1 + 1)
                    elif m.op == 2:
                        self._mmcop2(m.val1)
                    elif m.op == 3:
                        self._mmcop3(frame_num, m.val1 + 1, m.val2)
                    elif m.op == 4:
                        self._mmcop4(m.val1 - 1)
                    elif m.op == 5:
                        self._mmcop5()
                        self.last_contains_mmco5 = True
                        frame_num = 0
                    elif m.op == 6:
                        marked_long = self._mmcop6(frame_num, poc, m.val2)
                    else:
                        raise DpbError(f"MMCO op {m.op} unsupported")
            else:
                self._sliding_window()
            if not marked_long:
                if self.num_ref_frames >= self.max_ref_frames:
                    raise DpbError("DPB full of reference frames")
                cur.frame_num = frame_num
                cur.pic_num = frame_num
                cur.poc = poc
                cur.status = SHORT_TERM
                cur.to_be_displayed = to_be_displayed
                self.fullness += 1
                self.num_ref_frames += 1

        cur.is_idr = is_idr
        cur.pic_id = pic_id
        cur.num_err_mbs = num_err_mbs

        if self.no_reordering:
            self.out.append(cur)
        else:
            while self.fullness > self.dpb_size:
                if not self._output_picture():
                    raise DpbError("DPB overflow with nothing to output")
        self._sort()

    def flush(self) -> None:
        while self._output_picture():
            pass

    def drain_outputs(self) -> List[DpbPicture]:
        o, self.out = self.out, []
        return o
