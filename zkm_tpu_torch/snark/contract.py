"""Solidity verifier emission for the wrap's Groth16 proofs.

Copy of zkm_tpu/snark/contract.py (the same text, character for
character).

Reference analog: recursion/src/snark/libsnark/contract.go:3-253 renders
verifier.sol from a template with the gnark verifying key baked in.  This
emits the equivalent contract against the EVM's bn128 precompiles
(ecAdd 0x06, ecMul 0x07, pairing 0x08 — EIP-196/197, the same curve as
snark/bn254.py).
"""

from __future__ import annotations

from typing import List

from .groth16 import VerifyingKey

_TEMPLATE = """\
// SPDX-License-Identifier: MIT
// Auto-generated by zkm_tpu.snark.contract — do not edit.
pragma solidity ^0.8.0;

contract Verifier {{
    uint256 constant q = 21888242871839275222246405745257275088696311157297823662689037894645226208583;
    uint256 constant r = 21888242871839275222246405745257275088548364400416034343698204186575808495617;

    // Verifying key
    uint256 constant alphax = {alphax};
    uint256 constant alphay = {alphay};
    uint256 constant betax1 = {betax1};
    uint256 constant betax2 = {betax2};
    uint256 constant betay1 = {betay1};
    uint256 constant betay2 = {betay2};
    uint256 constant gammax1 = {gammax1};
    uint256 constant gammax2 = {gammax2};
    uint256 constant gammay1 = {gammay1};
    uint256 constant gammay2 = {gammay2};
    uint256 constant deltax1 = {deltax1};
    uint256 constant deltax2 = {deltax2};
    uint256 constant deltay1 = {deltay1};
    uint256 constant deltay2 = {deltay2};

{ic_constants}
    uint256 constant nPublic = {n_public};

    function negate(uint256 y) internal pure returns (uint256) {{
        return y == 0 ? 0 : q - y;
    }}

    function verifyProof(
        uint256[2] calldata a,
        uint256[2][2] calldata b,
        uint256[2] calldata c,
        uint256[{n_public}] calldata input
    ) external view returns (bool) {{
        // vk_x = IC0 + sum input_i * IC_i
        uint256[2] memory vkx = [ic0x, ic0y];
        {ic_accumulate}
        // e(-A, B) * e(alpha, beta) * e(vk_x, gamma) * e(C, delta) == 1
        uint256[24] memory pairs = [
            a[0], negate(a[1]), b[0][0], b[0][1], b[1][0], b[1][1],
            alphax, alphay, betax1, betax2, betay1, betay2,
            vkx[0], vkx[1], gammax1, gammax2, gammay1, gammay2,
            c[0], c[1], deltax1, deltax2, deltay1, deltay2
        ];
        uint256[1] memory out;
        bool ok;
        assembly {{
            ok := staticcall(gas(), 8, pairs, 768, out, 32)
        }}
        require(ok, "pairing precompile failed");
        return out[0] == 1;
    }}

    function ecMulAdd(uint256[2] memory acc, uint256 px, uint256 py,
                      uint256 s) internal view returns (uint256[2] memory) {{
        uint256[3] memory mulIn = [px, py, s];
        uint256[2] memory mulOut;
        uint256[4] memory addIn;
        uint256[2] memory addOut;
        bool ok;
        assembly {{
            ok := staticcall(gas(), 7, mulIn, 96, mulOut, 64)
        }}
        require(ok, "ecMul failed");
        addIn[0] = acc[0];
        addIn[1] = acc[1];
        addIn[2] = mulOut[0];
        addIn[3] = mulOut[1];
        assembly {{
            ok := staticcall(gas(), 6, addIn, 128, addOut, 64)
        }}
        require(ok, "ecAdd failed");
        return addOut;
    }}
}}
"""


def _g2_words(pt) -> List[int]:
    """G2 affine -> EVM pairing-precompile word order (imag, real)."""
    x, y = pt
    return [x.coeffs[1], x.coeffs[0], y.coeffs[1], y.coeffs[0]]


def emit_verifier_sol(vk: VerifyingKey) -> str:
    beta = _g2_words(vk.beta_g2)
    gamma = _g2_words(vk.gamma_g2)
    delta = _g2_words(vk.delta_g2)
    ic_constants = "".join(
        f"    uint256 constant ic{i}x = {pt[0].n};\n"
        f"    uint256 constant ic{i}y = {pt[1].n};\n"
        for i, pt in enumerate(vk.ic))
    ic_accumulate = "\n        ".join(
        f"vkx = ecMulAdd(vkx, ic{i}x, ic{i}y, input[{i - 1}]);"
        for i in range(1, len(vk.ic)))
    return _TEMPLATE.format(
        alphax=vk.alpha_g1[0].n, alphay=vk.alpha_g1[1].n,
        betax1=beta[0], betax2=beta[1], betay1=beta[2], betay2=beta[3],
        gammax1=gamma[0], gammax2=gamma[1],
        gammay1=gamma[2], gammay2=gamma[3],
        deltax1=delta[0], deltax2=delta[1],
        deltay1=delta[2], deltay2=delta[3],
        ic_constants=ic_constants,
        ic_accumulate=ic_accumulate,
        n_public=len(vk.ic) - 1)
