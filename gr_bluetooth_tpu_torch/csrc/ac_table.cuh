// The affine GF(2) map of the classic access code, compiled into
// detect_words.cu.  Symbol j < 68 of an access code (preamble, sync word,
// the first trailer symbols) is predicted from its 24 LAP symbols
// 38..61 (v_38 ... v_61) as
//
//   pred_j = C68[j] ^ XOR { v_(38+k) : bit k of A68_ROW[j] is set }
//
// These are the rows of A[:68] and C[:68] of
// gr_bluetooth_tpu_torch.core.access_code.affine_code() (the same map as
// ops/detect_kernel.py:ac_masks, there stored by columns);
// tests/test_torch_detect_table.py parses this file and holds it to
// ac_masks() bit for bit.  Rows 38..61 are the LAP symbols themselves.
#pragma once

#include <stdint.h>

namespace ac {

constexpr uint32_t A68_ROW[68] = {
    0x712b9du, 0x712b9du, 0x712b9du, 0x712b9du, 0x712b9du, 0x62573au,
    0xc4ae74u, 0x787775u, 0xf0eeeau, 0x10f649u, 0x21ec92u, 0x32f2b9u,
    0x14ceefu, 0x299ddeu, 0x221021u, 0x350bdfu, 0x1b3c23u, 0x4753dbu,
    0x8ea7b6u, 0x9d4f6cu, 0xcbb545u, 0x176a8au, 0x2ed514u, 0x5daa28u,
    0xca7fcdu, 0x65d407u, 0xba8393u, 0xf50726u, 0x1b25d1u, 0x364ba2u,
    0x1dbcd9u, 0x3b79b2u, 0x76f364u, 0xede6c8u, 0x5bcd90u, 0xc6b0bdu,
    0x7c4ae7u, 0xf895ceu, 0x000001u, 0x000002u, 0x000004u, 0x000008u,
    0x000010u, 0x000020u, 0x000040u, 0x000080u, 0x000100u, 0x000200u,
    0x000400u, 0x000800u, 0x001000u, 0x002000u, 0x004000u, 0x008000u,
    0x010000u, 0x020000u, 0x040000u, 0x080000u, 0x100000u, 0x200000u,
    0x400000u, 0x800000u, 0x800000u, 0x800000u, 0x800000u, 0x800000u,
    0x800000u, 0x800000u,
};

constexpr uint8_t C68[68] = {
    0, 1, 0, 1, 0, 1, 1, 1, 1, 1, 1, 0, 0, 1, 1, 1, 0,
    0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 1, 1, 1, 1, 0, 0, 0,
    1, 1, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 0, 1,
};

// Read in constant expressions only (device code may not refer to the
// arrays themselves)
__host__ __device__ constexpr uint32_t a68_row(int j) { return A68_ROW[j]; }
__host__ __device__ constexpr bool c68(int j) { return C68[j] != 0; }

// Symbol j's error plane is zero for every window: a LAP symbol predicts
// itself
__host__ __device__ constexpr bool trivial(int j)
{
    return j >= 38 && j < 62 && !C68[j] && A68_ROW[j] == 1u << (j - 38);
}

// Symbols with an error plane that can be non-zero, and the i-th of them
__host__ __device__ constexpr int n_planes()
{
    int n = 0;
    for (int j = 0; j < 68; ++j) n += !trivial(j);
    return n;
}

__host__ __device__ constexpr int plane_symbol(int i)
{
    for (int j = 0; j < 68; ++j)
        if (!trivial(j) && i-- == 0) return j;
    return -1;
}

}  // namespace ac
