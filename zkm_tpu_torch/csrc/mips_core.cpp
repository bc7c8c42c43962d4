// Native MIPS32 interpreter core for the zkVM emulator (host code, not a
// CUDA kernel).
//
// Copy of zkm_tpu's native/mips_core.cpp.  zkMIPS analog: the hot loop of
// emulator/src/state.rs (mips_step / execute) and memory.rs (paged memory
// with rtrace/wtrace and in-address-space page-hash bookkeeping).
// Semantics mirror the Python interpreter in zkm_tpu_torch/emulator
// exactly; Python remains the source of truth for syscalls — core_run()
// returns control on every `syscall` instruction, step limit, or fault
// (fast-interpreter / slow-path split).
//
// Build: zkm_tpu_torch/emulator/native.py compiles it with g++ at first use
// and loads it with ctypes.

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <map>
#include <memory>
#include <set>
#include <vector>

namespace {

constexpr uint32_t PAGE_ADDR_SIZE = 12;
constexpr uint32_t PAGE_SIZE = 1u << PAGE_ADDR_SIZE;
constexpr uint32_t PAGE_ADDR_MASK = PAGE_SIZE - 1;
constexpr uint32_t HASH_ADDRESS_BASE = 0x80000000u;
constexpr int HASH_LEVELS = 3;

struct Page {
    uint8_t data[PAGE_SIZE];
};

struct Core {
    // page index -> page
    std::map<uint32_t, std::unique_ptr<Page>> pages;
    // rtrace: page index -> snapshot at first touch in current segment
    std::map<uint32_t, std::unique_ptr<Page>> rtrace;
    // wtrace: dirty page indices per hash level
    std::set<uint32_t> wtrace[HASH_LEVELS];
    // const hash pages (content of untouched hash pages per level)
    uint8_t const_hash_pages[HASH_LEVELS][PAGE_SIZE];

    uint32_t regs[32] = {0};
    uint32_t pc = 0, next_pc = 4, hi = 0, lo = 0;
    uint32_t heap = 0, brk_ = 0, local_user = 0;
    uint64_t step = 0, cycle = 0;
    bool exited = false;

    Page* lookup(uint32_t page_index) {
        auto it = pages.find(page_index);
        return it == pages.end() ? nullptr : it->second.get();
    }

    Page* alloc(uint32_t page_index) {
        auto p = std::make_unique<Page>();
        std::memset(p->data, 0, PAGE_SIZE);
        Page* raw = p.get();
        pages[page_index] = std::move(p);
        return raw;
    }

    Page* alloc_hash(uint32_t page_index, int level) {
        auto p = std::make_unique<Page>();
        std::memcpy(p->data, const_hash_pages[level], PAGE_SIZE);
        Page* raw = p.get();
        pages[page_index] = std::move(p);
        return raw;
    }

    void set_hash_trace(uint32_t page_index, int level) {
        uint32_t hash_addr = (page_index << 5) + HASH_ADDRESS_BASE;
        uint32_t hp = hash_addr >> PAGE_ADDR_SIZE;
        Page* page = lookup(hp);
        if (!page) page = alloc_hash(hp, level);
        if (rtrace.find(hp) == rtrace.end()) {
            auto snap = std::make_unique<Page>();
            std::memcpy(snap->data, page->data, PAGE_SIZE);
            rtrace[hp] = std::move(snap);
        }
        if (level < HASH_LEVELS - 1) set_hash_trace(hp, level + 1);
    }

    void touch_read(uint32_t page_index, Page* page) {
        if (rtrace.find(page_index) == rtrace.end()) {
            auto snap = std::make_unique<Page>();
            if (page) std::memcpy(snap->data, page->data, PAGE_SIZE);
            else std::memset(snap->data, 0, PAGE_SIZE);
            rtrace[page_index] = std::move(snap);
            set_hash_trace(page_index, 0);
        }
    }

    uint32_t get_memory(uint32_t addr) {
        uint32_t pi = addr >> PAGE_ADDR_SIZE;
        Page* page = lookup(pi);
        if (!page) {
            touch_read(pi, nullptr);
            return 0;
        }
        touch_read(pi, page);
        uint32_t off = addr & PAGE_ADDR_MASK & ~3u;
        const uint8_t* d = page->data + off;
        return (uint32_t(d[0]) << 24) | (uint32_t(d[1]) << 16) |
               (uint32_t(d[2]) << 8) | uint32_t(d[3]);
    }

    void set_memory(uint32_t addr, uint32_t v) {
        uint32_t pi = addr >> PAGE_ADDR_SIZE;
        Page* page = lookup(pi);
        if (!page) page = alloc(pi);
        touch_read(pi, page);
        wtrace[0].insert(pi);
        uint32_t off = addr & PAGE_ADDR_MASK & ~3u;
        uint8_t* d = page->data + off;
        d[0] = v >> 24; d[1] = v >> 16; d[2] = v >> 8; d[3] = v;
    }
};

uint32_t sign_extension(uint32_t dat, uint32_t idx) {
    bool is_signed = ((dat >> (idx - 1)) & 1) != 0;
    uint32_t signed_bits = idx >= 32 ? 0 : (((1u << (32 - idx)) - 1) << idx);
    uint32_t mask = idx >= 32 ? 0xFFFFFFFFu : ((1u << idx) - 1);
    return is_signed ? ((dat & mask) | signed_bits) : (dat & mask);
}

uint32_t rotr(uint32_t x, uint32_t n) {
    n &= 31;
    return n == 0 ? x : ((x >> n) | (x << (32 - n)));
}

// ALU (mirror of state.rs execute / emulator/state.py _execute)
// Returns value; sets *fault on invalid instruction.
uint32_t execute_alu(Core& c, uint32_t insn, uint32_t rs, uint32_t rt,
                     uint32_t mem, bool* fault) {
    uint32_t opcode = insn >> 26;
    uint32_t fun = insn & 0x3F;
    if (opcode < 0x20) {
        if (opcode >= 8 && opcode < 0xF) {
            switch (opcode) {
                case 8: fun = 0x20; break;
                case 9: fun = 0x21; break;
                case 0xA: fun = 0x2A; break;
                case 0xB: fun = 0x2B; break;
                case 0xC: fun = 0x24; break;
                case 0xD: fun = 0x25; break;
                case 0xE: fun = 0x26; break;
            }
            opcode = 0;
        }
        if (opcode == 0) {
            uint32_t shamt = (insn >> 6) & 0x1F;
            if (fun < 0x20) {
                if (fun >= 0x08) return rs;
                if (fun == 0x00) return rt << shamt;
                if (fun == 0x02) {
                    uint32_t sel = (insn >> 21) & 0x1F;
                    if (sel == 1) return rotr(rt, shamt);
                    if (sel == 0) return rt >> shamt;
                } else if (fun == 0x03) {
                    return sign_extension(rt >> shamt, 32 - shamt);
                } else if (fun == 0x04) {
                    return rt << (rs & 0x1F);
                } else if (fun == 0x06) {
                    return rt >> (rs & 0x1F);
                } else if (fun == 0x07) {
                    uint32_t s = rs & 0x1F;
                    return sign_extension(rt >> s, 32 - s);
                }
            }
            switch (fun) {
                case 0x20: case 0x21: return rs + rt;
                case 0x22: case 0x23: return rs - rt;
                case 0x24: return rs & rt;
                case 0x25: return rs | rt;
                case 0x26: return rs ^ rt;
                case 0x27: return ~(rs | rt);
                case 0x2A: return int32_t(rs) < int32_t(rt) ? 1 : 0;
                case 0x2B: return rs < rt ? 1 : 0;
                case 0x34: return rs == rt ? 1 : 0;
            }
            return 0;
        }
        if (opcode == 0xF) return rt << 16;
        if (opcode == 0x1C) {  // SPECIAL2
            if (fun == 1) return rs;
            if (fun == 2) return rs * rt;
            if (fun == 0x20 || fun == 0x21) {  // clz/clo
                uint32_t x = fun == 0x20 ? ~rs : rs;
                uint32_t i = 0;
                while (x & 0x80000000u) { x <<= 1; i++; }
                return i;
            }
            return 0;
        }
        if (opcode == 0x1F) {  // SPECIAL3
            if (fun == 0) {
                uint32_t msbd = (insn >> 11) & 0x1F;
                uint32_t lsb = (insn >> 6) & 0x1F;
                uint64_t mask = (1ull << (msbd + 1)) - 1;
                return uint32_t((rs >> lsb) & mask);
            }
            if (fun == 4) {
                uint32_t msb = (insn >> 11) & 0x1F;
                uint32_t lsb = (insn >> 6) & 0x1F;
                uint32_t size = msb - lsb + 1;
                uint32_t mask = size >= 32 ? 0xFFFFFFFFu : ((1u << size) - 1);
                return (rt & ~(mask << lsb)) | ((rs & mask) << lsb);
            }
            if (fun == 0x3B) {  // rdhwr
                uint32_t rd = (insn >> 11) & 0x1F;
                if (rd == 0) return 1;
                if (rd == 29) return c.local_user;
                return 0;
            }
            if (fun == 0x20) {
                uint32_t shamt = (insn >> 6) & 0x1F;
                if (shamt == 0x18) return sign_extension(rt, 16);
                if (shamt == 0x10) return sign_extension(rt, 8);
                if (shamt == 0x02)
                    return (((rt >> 16) & 0xFF) << 24) |
                           (((rt >> 24) & 0xFF) << 16) |
                           ((rt & 0xFF) << 8) | ((rt >> 8) & 0xFF);
            }
            return 0;
        }
        return 0;
    }
    if (opcode < 0x28) {
        switch (opcode) {
            case 0x20: return sign_extension((mem >> (24 - (rs & 3) * 8)) & 0xFF, 8);
            case 0x21: return sign_extension((mem >> (16 - (rs & 2) * 8)) & 0xFFFF, 16);
            case 0x22: {
                uint32_t val = mem << ((rs & 3) * 8);
                uint32_t mask = 0xFFFFFFFFu << ((rs & 3) * 8);
                return (rt & ~mask) | val;
            }
            case 0x23: return mem;
            case 0x24: return (mem >> (24 - (rs & 3) * 8)) & 0xFF;
            case 0x25: return (mem >> (16 - (rs & 2) * 8)) & 0xFFFF;
            case 0x26: {
                uint32_t val = mem >> (24 - (rs & 3) * 8);
                uint32_t mask = 0xFFFFFFFFu >> (24 - (rs & 3) * 8);
                return (rt & ~mask) | val;
            }
        }
        *fault = true;
        return 0;
    }
    switch (opcode) {
        case 0x28: {
            uint32_t val = (rt & 0xFF) << (24 - (rs & 3) * 8);
            uint32_t mask = 0xFFFFFFFFu ^ (0xFFu << (24 - (rs & 3) * 8));
            return (mem & mask) | val;
        }
        case 0x29: {
            uint32_t val = (rt & 0xFFFF) << (16 - (rs & 2) * 8);
            uint32_t mask = 0xFFFFFFFFu ^ (0xFFFFu << (16 - (rs & 2) * 8));
            return (mem & mask) | val;
        }
        case 0x2A: {
            uint32_t val = rt >> ((rs & 3) * 8);
            uint32_t mask = 0xFFFFFFFFu >> ((rs & 3) * 8);
            return (mem & ~mask) | val;
        }
        case 0x2B: return rt;
        case 0x2E: {
            uint32_t val = rt << (24 - (rs & 3) * 8);
            uint32_t mask = 0xFFFFFFFFu << (24 - (rs & 3) * 8);
            return (mem & ~mask) | val;
        }
        case 0x30: return mem;
        case 0x33: return mem;
        case 0x38: return rt;
        case 0x3D: return 0;
    }
    *fault = true;
    return 0;
}

enum StopReason : int {
    STOP_STEPS = 0,
    STOP_SYSCALL = 1,
    STOP_FAULT = 2,
};

// One instruction; returns true to CONTINUE, false when the caller must
// take over (syscall) or a fault occurred.
bool step_one(Core& c, int* reason) {
    c.step += 1;
    c.cycle += 1;
    uint32_t insn = c.get_memory(c.pc);
    uint32_t opcode = insn >> 26;

    if (opcode == 2 || opcode == 3) {  // j / jal
        uint32_t link = opcode == 3 ? 31 : 0;
        uint32_t dest = sign_extension(insn & 0x03FFFFFF, 26) << 2;
        uint32_t prev = c.pc;
        c.pc = c.next_pc;
        c.next_pc = dest;
        if (link) c.regs[link] = prev + 8;
        return true;
    }

    uint32_t rt = 0;
    uint32_t rt_reg = (insn >> 16) & 0x1F;
    uint32_t rs = c.regs[(insn >> 21) & 0x1F];
    uint32_t rd_reg = rt_reg;
    uint32_t fun = insn & 0x3F;

    if (opcode == 0 || opcode == 0x1C ||
        (opcode == 0x1F && (fun == 0x20 || fun == 4))) {
        rt = c.regs[rt_reg];
        rd_reg = (insn >> 11) & 0x1F;
    } else if (opcode < 0x20) {
        if (opcode == 0xC || opcode == 0xD || opcode == 0xE)
            rt = insn & 0xFFFF;
        else
            rt = sign_extension(insn & 0xFFFF, 16);
    } else if (opcode >= 0x28 || opcode == 0x22 || opcode == 0x26) {
        rt = c.regs[rt_reg];
        rd_reg = rt_reg;
    }

    if ((opcode >= 4 && opcode < 8) || opcode == 1) {  // branches
        bool should = false;
        if (opcode == 4 || opcode == 5) {
            uint32_t rtv = c.regs[rt_reg];
            should = (rs == rtv && opcode == 4) || (rs != rtv && opcode == 5);
        } else if (opcode == 6) {
            should = int32_t(rs) <= 0;
        } else if (opcode == 7) {
            should = int32_t(rs) > 0;
        } else {
            uint32_t rtv = (insn >> 16) & 0x1F;
            if (rtv == 0) should = int32_t(rs) < 0;
            else if (rtv == 1) should = int32_t(rs) >= 0;
            else if (rtv == 0x11) { c.regs[31] = c.pc + 8; should = true; }
        }
        uint32_t prev = c.pc;
        c.pc = c.next_pc;
        if (should)
            c.next_pc = uint32_t(uint64_t(prev) + 4 +
                                 (uint64_t(sign_extension(insn & 0xFFFF, 16)) << 2));
        else
            c.next_pc += 4;
        return true;
    }

    bool has_store = false;
    uint32_t store_addr = 0;
    uint32_t mem = 0;
    if (opcode >= 0x20) {
        rs = uint32_t(uint64_t(rs) + uint64_t(sign_extension(insn & 0xFFFF, 16)));
        uint32_t addr = rs & 0xFFFFFFFCu;
        mem = c.get_memory(addr);
        if (opcode >= 0x28 && opcode != 0x30) {
            has_store = true;
            store_addr = addr;
            rd_reg = 0;
        }
    }

    bool fault = false;
    uint32_t val = execute_alu(c, insn, rs, rt, mem, &fault);
    if (fault) { *reason = STOP_FAULT; return false; }

    fun = insn & 0x3F;
    if (opcode == 0 && fun >= 8 && fun < 0x1C) {
        if (fun == 8 || fun == 9) {  // jr / jalr
            uint32_t link = fun == 9 ? rd_reg : 0;
            uint32_t prev = c.pc;
            c.pc = c.next_pc;
            c.next_pc = rs;
            if (link) c.regs[link] = prev + 8;
            return true;
        }
        if (fun == 0xA) {  // movz
            if (rd_reg && rt == 0) c.regs[rd_reg] = rs;
            c.pc = c.next_pc; c.next_pc += 4;
            return true;
        }
        if (fun == 0xB) {  // movn
            if (rd_reg && rt != 0) c.regs[rd_reg] = rs;
            c.pc = c.next_pc; c.next_pc += 4;
            return true;
        }
        if (fun == 0xC) {  // syscall -> python
            c.step -= 1;   // python re-executes this instruction's syscall
            c.cycle -= 1;
            *reason = STOP_SYSCALL;
            return false;
        }
        if (fun >= 0x10 && fun < 0x1C) {  // hi/lo
            uint32_t v = 0;
            switch (fun) {
                case 0x10: v = c.hi; break;
                case 0x11: c.hi = rs; break;
                case 0x12: v = c.lo; break;
                case 0x13: c.lo = rs; break;
                case 0x18: {
                    int64_t acc = int64_t(int32_t(rs)) * int64_t(int32_t(rt));
                    c.hi = uint32_t(uint64_t(acc) >> 32);
                    c.lo = uint32_t(uint64_t(acc));
                    break;
                }
                case 0x19: {
                    uint64_t acc = uint64_t(rs) * uint64_t(rt);
                    c.hi = uint32_t(acc >> 32);
                    c.lo = uint32_t(acc);
                    break;
                }
                case 0x1A: {
                    int32_t a = int32_t(rs), b = int32_t(rt);
                    if (b != 0) { c.hi = uint32_t(a % b); c.lo = uint32_t(a / b); }
                    else { c.hi = uint32_t(a); c.lo = 0; }
                    break;
                }
                case 0x1B: {
                    if (rt != 0) { c.hi = rs % rt; c.lo = rs / rt; }
                    else { c.hi = rs; c.lo = 0; }
                    break;
                }
                default: *reason = STOP_FAULT; return false;
            }
            if (rd_reg) c.regs[rd_reg] = v;
            c.pc = c.next_pc; c.next_pc += 4;
            return true;
        }
    }
    if (opcode == 0x1C && fun == 0x1) {  // maddu
        uint64_t acc = uint64_t(rs) * uint64_t(rt) +
                       ((uint64_t(c.hi) << 32) | uint64_t(c.lo));
        c.hi = uint32_t(acc >> 32);
        c.lo = uint32_t(acc);
        c.pc = c.next_pc; c.next_pc += 4;
        return true;
    }
    if (opcode == 0x38 && rt_reg != 0) c.regs[rt_reg] = 1;  // sc
    if (opcode == 0x33) {  // pref
        c.pc = c.next_pc; c.next_pc += 4;
        return true;
    }
    if (has_store) c.set_memory(store_addr, val);
    if (rd_reg) c.regs[rd_reg] = val;
    c.pc = c.next_pc;
    c.next_pc += 4;
    return true;
}

}  // namespace

extern "C" {

struct CoreRegs {
    uint32_t regs[32];
    uint32_t pc, next_pc, hi, lo, heap, brk_, local_user;
    uint64_t step, cycle;
};

void* core_new(const uint8_t* const_hash_pages /* 3 * 4096 bytes */) {
    Core* c = new Core();
    for (int l = 0; l < HASH_LEVELS; l++)
        std::memcpy(c->const_hash_pages[l], const_hash_pages + l * PAGE_SIZE,
                    PAGE_SIZE);
    return c;
}

void core_free(void* h) { delete static_cast<Core*>(h); }

void core_get_regs(void* h, CoreRegs* out) {
    Core& c = *static_cast<Core*>(h);
    std::memcpy(out->regs, c.regs, sizeof(c.regs));
    out->pc = c.pc; out->next_pc = c.next_pc; out->hi = c.hi; out->lo = c.lo;
    out->heap = c.heap; out->brk_ = c.brk_; out->local_user = c.local_user;
    out->step = c.step; out->cycle = c.cycle;
}

void core_set_regs(void* h, const CoreRegs* in) {
    Core& c = *static_cast<Core*>(h);
    std::memcpy(c.regs, in->regs, sizeof(c.regs));
    c.pc = in->pc; c.next_pc = in->next_pc; c.hi = in->hi; c.lo = in->lo;
    c.heap = in->heap; c.brk_ = in->brk_; c.local_user = in->local_user;
    c.step = in->step; c.cycle = in->cycle;
}

uint32_t core_get_memory(void* h, uint32_t addr) {
    return static_cast<Core*>(h)->get_memory(addr);
}

void core_set_memory(void* h, uint32_t addr, uint32_t v) {
    static_cast<Core*>(h)->set_memory(addr, v);
}

// Raw write without read-tracing (but marks dirty), used for bulk loads.
void core_write_block(void* h, uint32_t addr, const uint8_t* data,
                      uint32_t len) {
    Core& c = *static_cast<Core*>(h);
    uint32_t pos = 0;
    while (pos < len) {
        uint32_t pi = addr >> PAGE_ADDR_SIZE;
        uint32_t off = addr & PAGE_ADDR_MASK;
        Page* page = c.lookup(pi);
        if (!page) page = c.alloc(pi);
        c.touch_read(pi, page);
        c.wtrace[0].insert(pi);
        uint32_t n = PAGE_SIZE - off;
        if (n > len - pos) n = len - pos;
        std::memcpy(page->data + off, data + pos, n);
        pos += n;
        addr += n;
    }
}

// Segment-image restore: little-endian word, no tracing.
void core_init_memory(void* h, uint32_t addr, uint32_t v) {
    Core& c = *static_cast<Core*>(h);
    uint32_t pi = addr >> PAGE_ADDR_SIZE;
    Page* page = c.lookup(pi);
    if (!page) page = c.alloc(pi);
    uint32_t off = addr & PAGE_ADDR_MASK;
    uint8_t* d = page->data + off;
    d[0] = v; d[1] = v >> 8; d[2] = v >> 16; d[3] = v >> 24;
}

int core_run(void* h, uint64_t max_steps, uint64_t* steps_done) {
    Core& c = *static_cast<Core*>(h);
    int reason = STOP_STEPS;
    uint64_t done = 0;
    while (done < max_steps) {
        if (!step_one(c, &reason)) break;
        done++;
    }
    *steps_done = done;
    return reason;
}

uint64_t core_page_count(void* h) {
    return static_cast<Core*>(h)->rtrace.size();
}

uint64_t core_num_pages(void* h) {
    return static_cast<Core*>(h)->pages.size();
}

// rtrace iteration: fills up to cap entries (index, 4096-byte snapshot).
uint64_t core_rtrace_dump(void* h, uint32_t* indices, uint8_t* snapshots,
                          uint64_t cap) {
    Core& c = *static_cast<Core*>(h);
    uint64_t i = 0;
    for (auto& kv : c.rtrace) {
        if (i >= cap) break;
        indices[i] = kv.first;
        std::memcpy(snapshots + i * PAGE_SIZE, kv.second->data, PAGE_SIZE);
        i++;
    }
    return i;
}

void core_rtrace_clear(void* h) { static_cast<Core*>(h)->rtrace.clear(); }

uint64_t core_wtrace_count(void* h, int level) {
    return static_cast<Core*>(h)->wtrace[level].size();
}

uint64_t core_wtrace_dump(void* h, int level, uint32_t* indices,
                          uint64_t cap) {
    Core& c = *static_cast<Core*>(h);
    uint64_t i = 0;
    for (uint32_t pi : c.wtrace[level]) {
        if (i >= cap) break;
        indices[i] = pi;
        i++;
    }
    return i;
}

void core_wtrace_clear(void* h, int level) {
    static_cast<Core*>(h)->wtrace[level].clear();
}

void core_wtrace_add(void* h, int level, uint32_t pi) {
    static_cast<Core*>(h)->wtrace[level].insert(pi);
}

// Read a full page (allocating hash-const content if it's a hash page is
// NOT done here; missing pages read as zero).
void core_read_page(void* h, uint32_t page_index, uint8_t* out) {
    Core& c = *static_cast<Core*>(h);
    Page* p = c.lookup(page_index);
    if (p) std::memcpy(out, p->data, PAGE_SIZE);
    else std::memset(out, 0, PAGE_SIZE);
}

// Write 32 raw bytes at an arbitrary (aligned) address without tracing.
void core_write_raw(void* h, uint32_t addr, const uint8_t* data,
                    uint32_t len) {
    Core& c = *static_cast<Core*>(h);
    while (len > 0) {
        uint32_t pi = addr >> PAGE_ADDR_SIZE;
        uint32_t off = addr & PAGE_ADDR_MASK;
        Page* page = c.lookup(pi);
        if (!page) page = c.alloc(pi);
        uint32_t n = PAGE_SIZE - off;
        if (n > len) n = len;
        std::memcpy(page->data + off, data, n);
        data += n; len -= n; addr += n;
    }
}

}  // extern "C"
