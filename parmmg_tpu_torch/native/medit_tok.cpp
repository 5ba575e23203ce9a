// Native Medit tokenizer — the hot I/O loop of the framework's reader.
//
// The reference's Medit I/O layer is native C (inout_pmmg.c building on
// Mmg's readers); here the performance-critical part of loading —
// turning a multi-hundred-MB ASCII .mesh/.sol file into a token stream —
// is native C++, while section parsing/assembly stays in numpy
// (parmmg_tpu_torch/io/medit.py). Exposed via ctypes
// (parmmg_tpu_torch/io/native_io.py): medit_tokenize() returns a heap
// buffer of NUL-separated tokens ('#' comments stripped to end of line),
// medit_free() releases it.
//
// Built at first use by parmmg_tpu_torch/native/__init__.py
// (g++ -O2 -shared -fPIC) into parmmg_tpu_torch/_build/.

#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// Reads `path`, writes token bytes ('\0'-separated, no trailing
// separator) into a malloc'd buffer, stores the byte count in *nbytes.
// Returns nullptr on I/O failure. Caller frees with medit_free().
char *medit_tokenize(const char *path, long *nbytes) {
    FILE *f = std::fopen(path, "rb");
    if (!f) return nullptr;
    if (std::fseek(f, 0, SEEK_END) != 0) { std::fclose(f); return nullptr; }
    long sz = std::ftell(f);
    if (sz < 0) { std::fclose(f); return nullptr; }
    std::rewind(f);
    char *raw = static_cast<char *>(std::malloc(sz > 0 ? sz : 1));
    if (!raw) { std::fclose(f); return nullptr; }
    long got = static_cast<long>(std::fread(raw, 1, sz, f));
    std::fclose(f);
    if (got != sz) { std::free(raw); return nullptr; }

    // output can never exceed input size + 1 (one separator per token,
    // tokens shrink relative to the whitespace they replace)
    char *out = static_cast<char *>(std::malloc(sz + 1));
    if (!out) { std::free(raw); return nullptr; }
    long w = 0;
    bool in_tok = false;
    for (long i = 0; i < sz; ++i) {
        unsigned char c = static_cast<unsigned char>(raw[i]);
        if (c == '#') {  // comment to end of line
            while (i < sz && raw[i] != '\n') ++i;
            in_tok = false;
            continue;
        }
        if (c == ' ' || c == '\t' || c == '\r' || c == '\n' ||
            c == '\v' || c == '\f') {
            in_tok = false;
            continue;
        }
        if (!in_tok && w > 0) out[w++] = '\0';
        in_tok = true;
        out[w++] = static_cast<char>(c);
    }
    std::free(raw);
    *nbytes = w;
    return out;
}

void medit_free(char *buf) { std::free(buf); }

}  // extern "C"
