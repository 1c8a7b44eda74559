"""The SASS walk of ``kernels/profile_winding.py`` on a made-up listing in
``cuobjdump -sass``'s format: the function filter, branch targets by
address and by label, the face loop's common path (a branch around a
slow-path CALL taken, a plain forward branch not), and its counts a face.
Imports no JAX."""

from icon_tpu_torch.kernels.profile_winding import face_loop, sass_functions

NAME = "_ZN12_GLOBAL__N_119fast_winding_kernelILi8EEEvPKfiS2_iS2_iiPf"


def _listing(body, name=NAME):
    lines = ["\tcode for sm_90a", f"\t\tFunction : {name}",
             "\t.headerflags\t@\"EF_CUDA_SM90\""]
    addr = 0
    for text in body:
        if text.endswith(":"):
            lines.append(text)
            continue
        lines.append(f"        /*{addr:04x}*/                   {text} ;"
                     f"                 /* 0x000fe20000000f00 */")
        addr += 0x10
    return "\n".join(lines) + "\n"


LOOP = (["MOV R1, c[0x0][0x28]", ".L_x_1:"]
        + [f"LDG.E.CONSTANT R{i}, desc[UR4][R20.64+0x{4 * i:x}]"
           for i in range(10)]
        + ["FADD R2, R3, -R4",
           "@P0 BRA 0xf0",                       # around the slow path
           "CALL.REL.NOINC `(__internal_sqrt)",
           "MOV R5, R6",
           "BSSY B0, `(.L_x_2)",                 # the atan2f stand-in
           "MUFU.RCP R7, R8",
           "FMUL R9, R7, R10",
           "FADD R9, R9, R11",
           ".L_x_2:",
           "BSYNC B0",
           "DADD R12, R12, R14",
           "@P1 BRA 0x170",                      # no CALL: falls through
           "IADD3 R15, R15, 0x1, RZ",
           "@!P2 BRA `(.L_x_1)",
           "EXIT"])


def test_sass_functions_filter_and_targets():
    text = _listing(LOOP) + _listing(["EXIT"], "_Z5otherPf")
    funcs = sass_functions(text, "fast_winding_kernelILi8E")
    assert list(funcs) == [NAME]
    ins = funcs[NAME]
    assert len(ins) == 25 and ins[0] == (False, "MOV", "R1, c[0x0][0x28]")
    assert ins[12] == (True, "BRA", 15)          # by address
    assert ins[21] == (True, "BRA", 23)
    assert ins[23] == (True, "BRA", 1)           # by label
    assert sass_functions(text, "no such kernel") == {}


def test_face_loop_walks_the_common_path():
    loop = face_loop(sass_functions(_listing(LOOP), NAME)[NAME])
    assert loop["faces a trip"] == 1
    # the head's 10 loads, FADD and the branch; past the slow path BSSY to
    # the back branch: 21; the CALL and its MOV skipped
    assert loop["total"] == 21
    assert loop["per face"] == {"BRA": 3, "BSSY": 1, "BSYNC": 1, "DADD": 1,
                                "FADD": 2, "FMUL": 1, "IADD3": 1, "LDG": 10,
                                "MUFU": 1}
    assert loop["float"] == 5 and loop["atan2f"] == 5


def test_face_loop_needs_the_loads_and_a_reciprocal():
    no_rcp = [x.replace("MUFU.RCP", "MUFU.RSQ") for x in LOOP]
    assert face_loop(sass_functions(_listing(no_rcp), NAME)[NAME]) == {}
    few_loads = [x for x in LOOP if "0x24]" not in x]
    assert face_loop(sass_functions(_listing(few_loads), NAME)[NAME]) == {}
