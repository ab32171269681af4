// Copy of native/turbine.cpp in the PyTorch port (built by
// runmat_tpu_torch/native/__init__.py into build/runmat_tpu_torch/).
// Turbine: native tier-2 executor for scalar-numeric bytecode loops.
//
// Reference parity: runmat-turbine — the Cranelift JIT tier that compiles
// hot bytecode to native code (crates/runmat-turbine/src/compiler.rs:249,
// profiler threshold, fallback-on-unsupported). On TPU the array hot path is
// already XLA; the remaining Python-slow path is scalar host loops, which
// this stack VM executes at native speed. The Python side translates a
// restricted bytecode window (all-scalar doubles, arithmetic + comparisons +
// branches + libm intrinsics) into this ISA; anything else falls back to the
// interpreter, preserving the reference's "never required for correctness"
// invariant.
//
// Build: g++ -O2 -shared -fPIC -o libturbine.so turbine.cpp

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

enum Op : int32_t {
    OP_CONST = 0,    // a = const index        push consts[a]
    OP_LOAD = 1,     // a = slot               push slots[a]
    OP_STORE = 2,    // a = slot               slots[a] = pop
    OP_ADD = 3, OP_SUB = 4, OP_MUL = 5, OP_DIV = 6, OP_POW = 7,
    OP_NEG = 8,
    OP_LT = 9, OP_LE = 10, OP_GT = 11, OP_GE = 12, OP_EQ = 13, OP_NE = 14,
    OP_AND = 15, OP_OR = 16, OP_NOT = 17,
    OP_JMP = 18,          // a = target
    OP_JMP_IF_FALSE = 19, // a = target (pops)
    OP_JMP_IF_TRUE = 20,  // a = target (pops)
    OP_CALL1 = 21,        // a = intrinsic id   unary call
    OP_CALL2 = 22,        // a = intrinsic id   binary call
    OP_DUP = 23,
    OP_POP = 24,
    OP_HALT = 25,
    OP_LOADIDX = 26,      // a = array id       pop idx (1-based), push arr[idx]
    OP_STOREIDX = 27,     // a = array id       pop idx, pop value; arr[idx] = value
    OP_LOADIDX2 = 28,     // a = array id       pop j, pop i (1-based), push arr[i,j]
    OP_STOREIDX2 = 29,    // a = array id       pop j, pop i, pop value; arr[i,j] = v
    // subroutines (round 5: true calls replace bounded inlining, so deep
    // helper chains and RECURSION stay native — the reference Turbine
    // compiles general call bytecode, runmat-turbine/src/value_abi.rs):
    OP_ENTER = 30,        // a = frame size      declare current frame width
    OP_CALL = 31,         // a = target pc       push (ret, bp, fs); bp += fs
    OP_RETN = 32,         // return              pop (ret, bp, fs)
};

enum Fn1 : int32_t {
    F_SIN, F_COS, F_TAN, F_ASIN, F_ACOS, F_ATAN, F_SINH, F_COSH, F_TANH,
    F_EXP, F_LOG, F_LOG2, F_LOG10, F_SQRT, F_ABS, F_FLOOR, F_CEIL, F_ROUND,
    F_SIGN, F_FIX, F_EXPM1, F_LOG1P,
};

enum Fn2 : int32_t {
    F2_ATAN2, F2_HYPOT, F2_MOD, F2_REM, F2_MAX, F2_MIN, F2_POWER,
};

static double call1(int32_t f, double x) {
    switch (f) {
        case F_SIN: return sin(x);
        case F_COS: return cos(x);
        case F_TAN: return tan(x);
        case F_ASIN: return asin(x);
        case F_ACOS: return acos(x);
        case F_ATAN: return atan(x);
        case F_SINH: return sinh(x);
        case F_COSH: return cosh(x);
        case F_TANH: return tanh(x);
        case F_EXP: return exp(x);
        case F_LOG: return log(x);
        case F_LOG2: return log2(x);
        case F_LOG10: return log10(x);
        case F_SQRT: return sqrt(x);
        case F_ABS: return fabs(x);
        case F_FLOOR: return floor(x);
        case F_CEIL: return ceil(x);
        case F_ROUND: return round(x);
        case F_SIGN: return (x > 0) - (x < 0);
        case F_FIX: return trunc(x);
        case F_EXPM1: return expm1(x);
        case F_LOG1P: return log1p(x);
    }
    return NAN;
}

static double matlab_mod(double a, double b) {
    if (b == 0) return a;
    double r = fmod(a, b);
    if (r != 0 && ((r < 0) != (b < 0))) r += b;
    return r;
}

static double call2(int32_t f, double a, double b) {
    switch (f) {
        case F2_ATAN2: return atan2(a, b);
        case F2_HYPOT: return hypot(a, b);
        case F2_MOD: return matlab_mod(a, b);
        case F2_REM: return (b == 0) ? a : fmod(a, b);
        case F2_MAX: return (a >= b || std::isnan(b)) ? a : b;
        case F2_MIN: return (a <= b || std::isnan(b)) ? a : b;
        case F2_POWER: return pow(a, b);
    }
    return NAN;
}

// returns: 0 ok, 1 stack error, 2 step budget exceeded, 3 bad opcode,
//          4 bad subscript (non-integer or out of bounds -> host fallback
//          re-runs the loop through the interpreter for the real MATLAB
//          error/growth semantics), 5 frame overflow (call depth / slots)
// dirty[i] is set to 1 iff slot i was actually written by an executed STORE —
// the host only materializes dirty slots back into workspace variables, so a
// STORE inside a never-taken branch cannot conjure a variable into existence.
// arrays[k] are caller-owned f64 buffers (copies for write targets: the host
// binds them back only on status 0 with arr_dirty[k] set — COW semantics).
int32_t turbine_run(const int32_t* ops, const double* opargs, int32_t n_instr,
                    const double* consts, double* slots, uint8_t* dirty,
                    double** arrays, const int64_t* arr_lens,
                    const int64_t* arr_rows, uint8_t* arr_dirty,
                    int32_t n_arrays, int64_t max_steps,
                    int64_t slots_cap) {
    double stack[256];
    int sp = 0;
    int64_t steps = 0;
    int32_t pc = 0;
    // subroutine frames: LOAD/STORE are bp-relative (frame 0 => absolute)
    int64_t bp = 0;
    int32_t cur_fs = 0;
    const int kMaxFrames = 256;
    int32_t ret_pc[kMaxFrames];
    int64_t ret_bp[kMaxFrames];
    int32_t ret_fs[kMaxFrames];
    int rsp = 0;
    while (pc < n_instr) {
        if (++steps > max_steps) return 2;
        int32_t op = ops[pc];
        int32_t a = (int32_t)opargs[pc];
        pc++;
        switch (op) {
            case OP_CONST: stack[sp++] = consts[a]; break;
            case OP_LOAD: stack[sp++] = slots[bp + a]; break;
            case OP_STORE: slots[bp + a] = stack[--sp]; dirty[bp + a] = 1; break;
            case OP_ADD: sp--; stack[sp - 1] += stack[sp]; break;
            case OP_SUB: sp--; stack[sp - 1] -= stack[sp]; break;
            case OP_MUL: sp--; stack[sp - 1] *= stack[sp]; break;
            case OP_DIV: sp--; stack[sp - 1] /= stack[sp]; break;
            case OP_POW: sp--; stack[sp - 1] = pow(stack[sp - 1], stack[sp]); break;
            case OP_NEG: stack[sp - 1] = -stack[sp - 1]; break;
            case OP_LT: sp--; stack[sp - 1] = stack[sp - 1] < stack[sp]; break;
            case OP_LE: sp--; stack[sp - 1] = stack[sp - 1] <= stack[sp]; break;
            case OP_GT: sp--; stack[sp - 1] = stack[sp - 1] > stack[sp]; break;
            case OP_GE: sp--; stack[sp - 1] = stack[sp - 1] >= stack[sp]; break;
            case OP_EQ: sp--; stack[sp - 1] = stack[sp - 1] == stack[sp]; break;
            case OP_NE: sp--; stack[sp - 1] = stack[sp - 1] != stack[sp]; break;
            case OP_AND: sp--; stack[sp - 1] = (stack[sp - 1] != 0) && (stack[sp] != 0); break;
            case OP_OR: sp--; stack[sp - 1] = (stack[sp - 1] != 0) || (stack[sp] != 0); break;
            case OP_NOT: stack[sp - 1] = stack[sp - 1] == 0; break;
            case OP_JMP: pc = a; break;
            case OP_JMP_IF_FALSE: if (stack[--sp] == 0) pc = a; break;
            case OP_JMP_IF_TRUE: if (stack[--sp] != 0) pc = a; break;
            case OP_CALL1: stack[sp - 1] = call1(a, stack[sp - 1]); break;
            case OP_CALL2: sp--; stack[sp - 1] = call2(a, stack[sp - 1], stack[sp]); break;
            case OP_DUP: stack[sp] = stack[sp - 1]; sp++; break;
            case OP_POP: sp--; break;
            case OP_HALT: return 0;
            case OP_LOADIDX: {
                double di = stack[--sp];
                int64_t i = (int64_t)di;
                if ((double)i != di || i < 1 || a >= n_arrays ||
                    i > arr_lens[a]) return 4;
                stack[sp++] = arrays[a][i - 1];
                break;
            }
            case OP_STOREIDX: {
                double di = stack[--sp];
                double v = stack[--sp];
                int64_t i = (int64_t)di;
                if ((double)i != di || i < 1 || a >= n_arrays ||
                    i > arr_lens[a]) return 4;
                arrays[a][i - 1] = v;
                arr_dirty[a] = 1;
                break;
            }
            case OP_LOADIDX2: {
                double dj = stack[--sp];
                double di = stack[--sp];
                int64_t i = (int64_t)di, j = (int64_t)dj;
                if ((double)i != di || (double)j != dj || i < 1 || j < 1 ||
                    a >= n_arrays || i > arr_rows[a]) return 4;
                int64_t lin = (j - 1) * arr_rows[a] + i;
                if (lin > arr_lens[a]) return 4;
                stack[sp++] = arrays[a][lin - 1];
                break;
            }
            case OP_STOREIDX2: {
                double dj = stack[--sp];
                double di = stack[--sp];
                double v = stack[--sp];
                int64_t i = (int64_t)di, j = (int64_t)dj;
                if ((double)i != di || (double)j != dj || i < 1 || j < 1 ||
                    a >= n_arrays || i > arr_rows[a]) return 4;
                int64_t lin = (j - 1) * arr_rows[a] + i;
                if (lin > arr_lens[a]) return 4;
                arrays[a][lin - 1] = v;
                arr_dirty[a] = 1;
                break;
            }
            case OP_ENTER:
                cur_fs = a;
                if (bp + a > slots_cap) return 5;
                break;
            case OP_CALL:
                if (rsp >= kMaxFrames) return 5;
                ret_pc[rsp] = pc;        // pc already advanced: return addr
                ret_bp[rsp] = bp;
                ret_fs[rsp] = cur_fs;
                rsp++;
                bp += cur_fs;
                pc = a;                  // target starts with OP_ENTER
                break;
            case OP_RETN:
                if (rsp <= 0) return 3;
                rsp--;
                pc = ret_pc[rsp];
                bp = ret_bp[rsp];
                cur_fs = ret_fs[rsp];
                break;
            default: return 3;
        }
        if (sp < 0 || sp > 250) return 1;
    }
    return 0;
}

}  // extern "C"
