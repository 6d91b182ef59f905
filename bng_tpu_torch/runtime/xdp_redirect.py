"""XDP xskmap-redirect program: load + attach via raw bpf(2) syscalls
(copy of `bng_tpu/runtime/xdp_redirect.py`).

An AF_XDP socket only receives traffic that an XDP program redirects into
it through an XSKMAP — binding alone is not enough. The Go BNG ships
compiled BPF objects and loads them with cilium/ebpf
(pkg/ebpf/loader.go:176-322); here the one program the accelerator
build still needs in the kernel is this six-instruction redirect
trampoline, so it is assembled inline and loaded through the raw bpf(2)
syscall — no clang, no libbpf, and the kernel VERIFIER still checks it
(the reference's verifier-gate discipline, bpf/test-verifier.sh).

    prog:  r2 = ctx->rx_queue_index
           r1 = &xsks_map           (ld_imm64 BPF_PSEUDO_MAP_FD)
           r3 = XDP_PASS            (fallback when the map slot is empty)
           call bpf_redirect_map
           exit

Attachment uses bpf_link (BPF_LINK_CREATE, kernel >= 5.7) in generic/SKB
mode — the same driver->generic degradation as the attach ladder. The
link fd pins the attachment: closing it detaches, so cleanup is
crash-safe (process death detaches the program automatically).
"""

from __future__ import annotations

import ctypes as C
import os
import socket
import struct

_SYS_BPF = 321  # x86_64

BPF_MAP_CREATE = 0
BPF_MAP_UPDATE_ELEM = 2
BPF_MAP_DELETE_ELEM = 3
BPF_PROG_LOAD = 5
BPF_LINK_CREATE = 28

BPF_MAP_TYPE_XSKMAP = 17
BPF_PROG_TYPE_XDP = 6
BPF_XDP = 37  # attach_type
BPF_PSEUDO_MAP_FD = 1
BPF_F_XDP_SKB_MODE = 1 << 1  # XDP_FLAGS_SKB_MODE (generic rung)

BPF_FUNC_redirect_map = 51
XDP_PASS = 2

_libc = C.CDLL(None, use_errno=True)


def _bpf(cmd: int, attr: bytes) -> int:
    buf = C.create_string_buffer(attr, len(attr))
    rc = _libc.syscall(_SYS_BPF, cmd, buf, len(attr))
    if rc < 0:
        err = C.get_errno()
        raise OSError(err, f"bpf(cmd={cmd}): {os.strerror(err)}")
    return rc


def _insn(code: int, dst: int, src: int, off: int, imm: int) -> bytes:
    return struct.pack("<BBhi", code, (src << 4) | dst, off, imm)


class XdpRedirect:
    """Loaded + attached xskmap-redirect program on one interface.

    Create with the interface name and a mapping of queue -> AF_XDP
    socket fd. Detaches and releases everything on close() (or process
    exit — all state is fd-backed)."""

    def __init__(self, ifname: str, xsk_fds: dict[int, int],
                 max_queues: int = 64):
        self.ifname = ifname
        self.map_fd = -1
        self.prog_fd = -1
        self.link_fd = -1
        try:
            self._load(ifname, xsk_fds, max_queues)
        except BaseException:
            self.close()
            raise

    def _load(self, ifname: str, xsk_fds: dict[int, int],
              max_queues: int) -> None:
        ifindex = socket.if_nametoindex(ifname)

        # xsks_map: queue index -> socket fd
        attr = struct.pack("<IIIII", BPF_MAP_TYPE_XSKMAP, 4, 4,
                           max_queues, 0).ljust(128, b"\x00")
        self.map_fd = _bpf(BPF_MAP_CREATE, attr)
        for queue, fd in xsk_fds.items():
            self.update_queue(queue, fd)

        insns = b"".join([
            _insn(0x61, 2, 1, 16, 0),                 # r2 = ctx->rx_queue_index
            _insn(0x18, 1, BPF_PSEUDO_MAP_FD, 0, self.map_fd),  # r1 = map
            _insn(0x00, 0, 0, 0, 0),                  # (ld_imm64 second half)
            _insn(0xB7, 3, 0, 0, XDP_PASS),           # r3 = XDP_PASS fallback
            _insn(0x85, 0, 0, 0, BPF_FUNC_redirect_map),
            _insn(0x95, 0, 0, 0, 0),                  # exit
        ])
        license_ = C.create_string_buffer(b"GPL")
        insn_buf = C.create_string_buffer(insns, len(insns))
        log_buf = C.create_string_buffer(4096)
        # bpf_attr PROG_LOAD layout: prog_type, insn_cnt, insns*, license*,
        # log_level, log_size, log_buf*, kern_version, prog_flags,
        # prog_name[16], prog_ifindex, expected_attach_type
        attr = struct.pack(
            "<IIQQIIQII16sII",
            BPF_PROG_TYPE_XDP, len(insns) // 8,
            C.addressof(insn_buf), C.addressof(license_),
            1, len(log_buf), C.addressof(log_buf),
            0, 0, b"bng_xsk_redir", 0, BPF_XDP).ljust(128, b"\x00")
        try:
            self.prog_fd = _bpf(BPF_PROG_LOAD, attr)
        except OSError as e:
            log = log_buf.value.decode(errors="replace").strip()
            raise OSError(e.errno,
                          f"XDP prog rejected by verifier: {log[-400:]}") from e

        # bpf_link attach (generic/SKB rung; detaches when the fd closes)
        attr = struct.pack("<IIII", self.prog_fd, ifindex, BPF_XDP,
                           BPF_F_XDP_SKB_MODE).ljust(128, b"\x00")
        self.link_fd = _bpf(BPF_LINK_CREATE, attr)

    def update_queue(self, queue: int, xsk_fd: int) -> None:
        key = struct.pack("<I", queue)
        val = struct.pack("<I", xsk_fd)
        kb = C.create_string_buffer(key, 4)
        vb = C.create_string_buffer(val, 4)
        attr = struct.pack("<IIQQQ", self.map_fd, 0, C.addressof(kb),
                           C.addressof(vb), 0).ljust(128, b"\x00")
        _bpf(BPF_MAP_UPDATE_ELEM, attr)

    def close(self) -> None:
        for name in ("link_fd", "prog_fd", "map_fd"):
            fd = getattr(self, name)
            if fd >= 0:
                try:
                    os.close(fd)
                except OSError:
                    pass
                setattr(self, name, -1)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def probe() -> bool:
    """Can this process create BPF maps (CAP_BPF/CAP_SYS_ADMIN)?"""
    try:
        attr = struct.pack("<IIIII", BPF_MAP_TYPE_XSKMAP, 4, 4, 1,
                           0).ljust(128, b"\x00")
        fd = _bpf(BPF_MAP_CREATE, attr)
        os.close(fd)
        return True
    except OSError:
        return False
