// The leaf launch op: one PyTorch operator through which an exported
// program launches the port's kernels, so that a loaded artifact needs
// PyTorch and the kernels' libraries alone (``ops/launch.py``).
//
//   psat_launch::launch(str lib, str entry, SymInt[] ints, int[] layout,
//                       Tensor[] tensors, SymInt[] out_sizes,
//                       int[] out_meta) -> Tensor[]
//
// ``lib`` names a kernel library by the sha256 of its bytes; ``bind(lib,
// path)`` opens it (dlopen) beforehand, once per key.  ``entry`` is its uniform C entry,
//
//   int entry(int device, const int64_t* scalars, const void* const* args,
//             void* stream)
//
// which every csrc/*.cu defines beside its own launcher.  The op allocates
// the outputs (``out_meta``: a dtype code and a rank per output, the sizes
// in ``out_sizes``), builds the argument blocks that ``layout`` describes
// over ``ints``, and calls the entry on the current stream of the tensors'
// card:
//
//   layout = [n_scalars, n_args, (kind, length) per arg,
//             n_align, (int index, bytes) per rule]
//   ints   = [scalars..., each arg's payload...]
//
// An arg of kind 0 is a null pointer; kind 1 a block of ``length`` int64;
// kind 2 a block of ``length`` device pointers, each a (slot, element
// offset) pair in ``ints`` (slot -1: null; slots index the input tensors,
// then the outputs).  An alignment rule sets ints[index] to 0 where some
// pointer of the launch is not a multiple of ``bytes`` (index -1: the
// launch raises instead).  A refused launch raises; there is no other
// kernel.  The Meta kernel allocates the outputs only; the CUDA kernel is
// compiled where the CUDA toolkit is (``PSAT_WITH_CUDA``).

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <torch/library.h>

#include <dlfcn.h>

#include <atomic>
#include <cstdint>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <vector>

#ifdef PSAT_WITH_CUDA
#include <c10/cuda/CUDAStream.h>
#endif

namespace {

using Entry = int (*)(int, const int64_t*, const void* const*, void*);
using ErrorString = const char* (*)(int);

struct Library {
    void* handle = nullptr;
    std::string path;
    ErrorString error_string = nullptr;
    std::map<std::string, Entry> entries;
    std::atomic<int64_t> launches{0};
};

std::mutex mu;
std::map<std::string, std::unique_ptr<Library>> libraries;

void bind(std::string lib, std::string path) {
    std::lock_guard<std::mutex> guard(mu);
    // a key names a library's bytes: one copy serves every artifact
    if (libraries.count(lib)) return;
    void* h = dlopen(path.c_str(), RTLD_NOW | RTLD_LOCAL);
    TORCH_CHECK(h != nullptr, "psat_launch: cannot load ", path, ": ",
                dlerror());
    auto err = reinterpret_cast<ErrorString>(dlsym(h, "psat_error_string"));
    if (err == nullptr) {
        dlclose(h);
        TORCH_CHECK(false, "psat_launch: ", path,
                    " has no psat_error_string: no kernel library");
    }
    auto L = std::make_unique<Library>();
    L->handle = h;
    L->path = path;
    L->error_string = err;
    libraries.emplace(lib, std::move(L));
}

Library& library(const std::string& lib) {
    std::lock_guard<std::mutex> guard(mu);
    auto it = libraries.find(lib);
    TORCH_CHECK(it != libraries.end(), "psat_launch: library ", lib,
                " is not bound (load the artifact's libraries first)");
    return *it->second;
}

int64_t launch_count(std::string lib) {
    std::lock_guard<std::mutex> guard(mu);
    auto it = libraries.find(lib);
    return it == libraries.end() ? 0 : it->second->launches.load();
}

void reset_launch_counts() {
    std::lock_guard<std::mutex> guard(mu);
    for (auto& kv : libraries) kv.second->launches = 0;
}

at::ScalarType dtype_of(int64_t code) {
    switch (code) {
        case 0: return at::kFloat;
        case 1: return at::kDouble;
        case 2: return at::kBFloat16;
        default: TORCH_CHECK(false, "psat_launch: unknown dtype code ", code);
    }
}

// The outputs' (dtype, sizes), from out_meta and out_sizes.
template <typename Size, typename Make>
std::vector<at::Tensor> outputs(c10::ArrayRef<Size> sizes,
                                at::IntArrayRef meta, Make make) {
    TORCH_CHECK(meta.size() % 2 == 0, "psat_launch: bad out_meta");
    std::vector<at::Tensor> outs;
    size_t pos = 0;
    for (size_t i = 0; i < meta.size(); i += 2) {
        const size_t rank = static_cast<size_t>(meta[i + 1]);
        TORCH_CHECK(pos + rank <= sizes.size(), "psat_launch: bad out_sizes");
        outs.push_back(make(sizes.slice(pos, rank), dtype_of(meta[i])));
        pos += rank;
    }
    TORCH_CHECK(pos == sizes.size(), "psat_launch: bad out_sizes");
    return outs;
}

std::vector<at::Tensor> launch_meta(std::string lib, std::string entry,
                                    c10::SymIntArrayRef ints,
                                    at::IntArrayRef layout,
                                    at::TensorList tensors,
                                    c10::SymIntArrayRef out_sizes,
                                    at::IntArrayRef out_meta) {
    return outputs(out_sizes, out_meta,
                   [](c10::SymIntArrayRef s, at::ScalarType st) {
                       return at::empty_symint(
                           s, at::TensorOptions().dtype(st).device(at::kMeta));
                   });
}

#ifdef PSAT_WITH_CUDA
std::vector<at::Tensor> launch_cuda(std::string lib, std::string entry,
                                    c10::SymIntArrayRef ints_s,
                                    at::IntArrayRef layout,
                                    at::TensorList tensors,
                                    c10::SymIntArrayRef out_sizes,
                                    at::IntArrayRef out_meta) {
    TORCH_CHECK(!tensors.empty(), "psat_launch: no tensors");
    const at::Device dev = tensors[0].device();
    for (const auto& t : tensors)
        TORCH_CHECK(t.device() == dev, "psat_launch: tensors on ", dev,
                    " and ", t.device());
    std::vector<int64_t> ints;
    ints.reserve(ints_s.size());
    for (const auto& s : ints_s) ints.push_back(s.expect_int());
    std::vector<int64_t> sizes;
    for (const auto& s : out_sizes) sizes.push_back(s.expect_int());
    std::vector<at::Tensor> outs = outputs(
        at::IntArrayRef(sizes), out_meta,
        [&](at::IntArrayRef s, at::ScalarType st) {
            return at::empty(s, tensors[0].options().dtype(st));
        });
    auto slot = [&](int64_t i) -> const at::Tensor& {
        const int64_t n = static_cast<int64_t>(tensors.size());
        TORCH_CHECK(i >= 0 && i < n + static_cast<int64_t>(outs.size()),
                    "psat_launch: bad tensor slot ", i);
        return i < n ? tensors[i] : outs[i - n];
    };

    // the argument blocks: an int block points into `ints` itself
    size_t li = 0;
    auto next = [&]() {
        TORCH_CHECK(li < layout.size(), "psat_launch: bad layout");
        return layout[li++];
    };
    const int64_t n_scalars = next(), n_args = next();
    size_t pos = static_cast<size_t>(n_scalars);
    std::vector<std::pair<int64_t, size_t>> where;  // (kind, offset)
    std::vector<std::vector<void*>> ptr_blocks;
    std::vector<void*> all_ptrs;
    for (int64_t a = 0; a < n_args; ++a) {
        const int64_t kind = next(), len = next();
        const size_t width = kind == 2 ? 2 * len : kind == 1 ? len : 0;
        TORCH_CHECK(kind >= 0 && kind <= 2 && pos + width <= ints.size(),
                    "psat_launch: bad layout");
        if (kind == 2) {
            std::vector<void*> ptrs;
            for (int64_t q = 0; q < len; ++q) {
                const int64_t s = ints[pos + 2 * q];
                void* p = nullptr;
                if (s >= 0) {
                    const at::Tensor& t = slot(s);
                    p = static_cast<char*>(t.data_ptr())
                        + ints[pos + 2 * q + 1] * t.element_size();
                    all_ptrs.push_back(p);
                }
                ptrs.push_back(p);
            }
            ptr_blocks.push_back(std::move(ptrs));
            where.emplace_back(2, ptr_blocks.size() - 1);
        } else {
            where.emplace_back(kind, pos);
        }
        pos += width;
    }
    const int64_t n_align = next();
    for (int64_t r = 0; r < n_align; ++r) {
        const int64_t index = next(), bytes = next();
        bool aligned = true;
        for (void* p : all_ptrs)
            aligned = aligned && reinterpret_cast<uintptr_t>(p) % bytes == 0;
        if (aligned) continue;
        TORCH_CHECK(index >= 0, "psat_launch: ", lib, " needs ", bytes,
                    "-byte aligned tensors");
        TORCH_CHECK(static_cast<size_t>(index) < ints.size(),
                    "psat_launch: bad alignment rule");
        ints[index] = 0;
    }
    std::vector<const void*> args;
    for (const auto& w : where)
        args.push_back(w.first == 1   ? static_cast<const void*>(
                                            ints.data() + w.second)
                       : w.first == 2 ? static_cast<const void*>(
                                            ptr_blocks[w.second].data())
                                      : nullptr);

    Library& L = library(lib);
    Entry fn = nullptr;
    {
        std::lock_guard<std::mutex> guard(mu);
        auto it = L.entries.find(entry);
        if (it == L.entries.end()) {
            fn = reinterpret_cast<Entry>(dlsym(L.handle, entry.c_str()));
            TORCH_CHECK(fn != nullptr, "psat_launch: ", L.path, " has no ",
                        entry);
            L.entries.emplace(entry, fn);
        } else {
            fn = it->second;
        }
    }
    void* stream = c10::cuda::getCurrentCUDAStream(dev.index()).stream();
    const int rc = fn(static_cast<int>(dev.index()), ints.data(),
                      args.data(), stream);
    TORCH_CHECK(rc == 0, "psat_launch: launch of ", L.path, " (", entry,
                ") failed: ", L.error_string(rc), " (code ", rc, ")");
    L.launches += 1;
    return outs;
}
#endif

}  // namespace

TORCH_LIBRARY(psat_launch, m) {
    m.def("launch(str lib, str entry, SymInt[] ints, int[] layout, "
          "Tensor[] tensors, SymInt[] out_sizes, int[] out_meta) -> Tensor[]");
    m.def("bind(str lib, str path) -> ()", &bind);
    m.def("launch_count(str lib) -> int", &launch_count);
    m.def("reset_launch_counts() -> ()", &reset_launch_counts);
}

TORCH_LIBRARY_IMPL(psat_launch, Meta, m) {
    m.impl("launch", &launch_meta);
}

#ifdef PSAT_WITH_CUDA
TORCH_LIBRARY_IMPL(psat_launch, CUDA, m) {
    m.impl("launch", &launch_cuda);
}
#endif
