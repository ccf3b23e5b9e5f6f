// Native protobuf-wire indexer for Caffe .caffemodel files.
//
// The reference's model IO is native C++ (protobuf) inside the Caffe fork;
// this gives channel_pruning_tpu the same: a single pass over the wire
// format that emits (layer, blob) records with data OFFSETS so Python can
// np.frombuffer the float payloads zero-copy. A 553 MB VGG-16 import drops
// from ~9 s (pure-Python field walk) to wire speed.
//
// Supported wire constructs (everything the reference's released models and
// our own exporter emit): NetParameter.name(1), modern layer(100) /
// legacy layers(2); LayerParameter name(1)/type(2)/blobs(7), V1 name(4)/
// type-enum(5)/blobs(6); BlobProto shape(7){packed or repeated dim(1)},
// legacy num/channels/height/width(1-4), packed float data(5), packed
// double data(8); diff(6)/double_diff(9) are skipped. Anything else
// structurally unexpected -> return -1 and
// the caller falls back to the pure-Python parser (identical semantics).

#include <cstdint>
#include <cstring>

namespace {

struct Reader {
    const uint8_t* p;
    int64_t n;
    int64_t pos = 0;
    bool ok = true;

    uint64_t varint() {
        uint64_t r = 0;
        int shift = 0;
        while (pos < n) {
            uint8_t b = p[pos++];
            r |= (uint64_t)(b & 0x7F) << shift;
            if (!(b & 0x80)) return r;
            shift += 7;
            if (shift > 63) break;
        }
        ok = false;
        return 0;
    }
    // returns (field, wiretype); advances past the tag
    bool tag(uint32_t* field, uint32_t* wt) {
        if (pos >= n) return false;
        uint64_t k = varint();
        if (!ok) return false;
        *field = (uint32_t)(k >> 3);
        *wt = (uint32_t)(k & 7);
        return true;
    }
    // skip a value of the given wiretype; for wt==2 returns (off,len)
    bool value(uint32_t wt, int64_t* off, int64_t* len) {
        switch (wt) {
            case 0: varint(); return ok;
            case 1: pos += 8; return pos <= n;
            case 2: {
                uint64_t l = varint();
                if (!ok || pos + (int64_t)l > n) return false;
                if (off) *off = pos;
                if (len) *len = (int64_t)l;
                pos += (int64_t)l;
                return true;
            }
            case 5: pos += 4; return pos <= n;
            default: return false;
        }
    }
};

// record layout (int64 x 12) written to `out`:
//  layer record: [0, name_off, name_len, type_off, type_len_or_enum, is_v1,
//                 0,0,0,0,0,0]
//     modern:  is_v1=0, type_off/type_len point at the type string
//     legacy:  is_v1=1, type_off=-1, type_len_or_enum = V1 LayerType enum
//  blob record:  [1, data_off, data_count, dtype(0=f32,1=f64), ndim,
//                 d0,d1,d2,d3,d4,d5, 0]  (belongs to the preceding layer)
constexpr int64_t REC = 12;

int64_t emit(int64_t* out, int64_t cap, int64_t idx, const int64_t* rec) {
    if (out && idx < cap) std::memcpy(out + idx * REC, rec, REC * sizeof(int64_t));
    return idx + 1;
}

bool parse_blob(Reader sub, int64_t base, int64_t* out, int64_t cap,
                int64_t* idx) {
    int64_t rec[REC] = {1, -1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
    int64_t dims[6];
    int ndim = 0;
    int64_t legacy[4] = {-1, -1, -1, -1};
    int data_chunks = 0;
    uint32_t f, wt;
    while (sub.tag(&f, &wt)) {
        int64_t off = 0, len = 0;
        if (f == 7 && wt == 2) {               // BlobShape
            if (!sub.value(wt, &off, &len)) return false;
            Reader sh{sub.p, off + len};
            sh.pos = off;
            uint32_t f2, w2;
            while (sh.pos < off + len && sh.tag(&f2, &w2)) {
                if (f2 == 1 && w2 == 2) {      // packed dims
                    int64_t o2 = 0, l2 = 0;
                    if (!sh.value(w2, &o2, &l2)) return false;
                    Reader dv{sh.p, o2 + l2};
                    dv.pos = o2;
                    while (dv.pos < o2 + l2) {
                        uint64_t d = dv.varint();
                        if (!dv.ok || ndim >= 6) return false;
                        dims[ndim++] = (int64_t)d;
                    }
                } else if (f2 == 1 && w2 == 0) {
                    uint64_t d = sh.varint();
                    if (!sh.ok || ndim >= 6) return false;
                    dims[ndim++] = (int64_t)d;
                } else if (!sh.value(w2, nullptr, nullptr)) {
                    return false;
                }
            }
        } else if (f == 5 && wt == 2) {        // packed float data
            if (!sub.value(wt, &off, &len)) return false;
            if (data_chunks++ || (len & 3)) return false;  // single chunk only
            rec[1] = base + off;
            rec[2] = len / 4;
            rec[3] = 0;
        } else if (f == 8 && wt == 2) {        // packed double data
            if (!sub.value(wt, &off, &len)) return false;
            if (data_chunks++ || (len & 7)) return false;
            rec[1] = base + off;
            rec[2] = len / 8;
            rec[3] = 1;
        } else if ((f == 6 || f == 9) && wt == 2) {
            // diff / double_diff: gradients, skip without claiming data
            if (!sub.value(wt, &off, &len)) return false;
        } else if (f == 5 && wt == 5) {
            return false;                      // unpacked floats: fall back
        } else if (f >= 1 && f <= 4 && wt == 0) {
            uint64_t v = sub.varint();
            if (!sub.ok) return false;
            legacy[f - 1] = (int64_t)v;
        } else if (!sub.value(wt, nullptr, nullptr)) {
            return false;
        }
    }
    if (!sub.ok) return false;
    if (ndim == 0 && (legacy[0] >= 0 || legacy[1] >= 0 || legacy[2] >= 0 ||
                      legacy[3] >= 0)) {
        for (int i = 0; i < 4; i++) dims[i] = legacy[i] >= 0 ? legacy[i] : 1;
        ndim = 4;
    }
    rec[4] = ndim;
    for (int i = 0; i < ndim; i++) rec[5 + i] = dims[i];
    *idx = emit(out, cap, *idx, rec);
    return true;
}

bool parse_layer(Reader sub, int64_t base, bool v1, int64_t* out, int64_t cap,
                 int64_t* idx) {
    int64_t rec[REC] = {0, -1, 0, -1, 0, v1 ? 1 : 0, 0, 0, 0, 0, 0, 0};
    int64_t layer_slot = *idx;
    *idx = emit(out, cap, *idx, rec);          // placeholder; rewritten below
    uint32_t name_f = v1 ? 4u : 1u;
    uint32_t blobs_f = v1 ? 6u : 7u;
    uint32_t f, wt;
    while (sub.tag(&f, &wt)) {
        int64_t off = 0, len = 0;
        if (f == name_f && wt == 2) {
            if (!sub.value(wt, &off, &len)) return false;
            rec[1] = base + off;
            rec[2] = len;
        } else if (!v1 && f == 2 && wt == 2) { // modern type string
            if (!sub.value(wt, &off, &len)) return false;
            rec[3] = base + off;
            rec[4] = len;
        } else if (v1 && f == 5 && wt == 0) {  // V1 type enum
            uint64_t v = sub.varint();
            if (!sub.ok) return false;
            rec[3] = -1;
            rec[4] = (int64_t)v;
        } else if (f == blobs_f && wt == 2) {
            if (!sub.value(wt, &off, &len)) return false;
            Reader b{sub.p, off + len};
            b.pos = off;
            if (!parse_blob(b, 0, out, cap, idx)) return false;
        } else if (!sub.value(wt, nullptr, nullptr)) {
            return false;
        }
    }
    if (!sub.ok) return false;
    if (out && layer_slot < cap)
        std::memcpy(out + layer_slot * REC, rec, REC * sizeof(int64_t));
    return true;
}

}  // namespace

extern "C" {

// Index the NetParameter wire format. Returns the number of records (layers
// + blobs), or -1 on any unsupported construct (caller falls back to the
// Python parser). With out==nullptr just counts. net_name_off/len receive
// the NetParameter.name location (-1 if absent).
int64_t cp_caffemodel_index(const uint8_t* buf, int64_t n, int64_t* out,
                            int64_t cap, int64_t* net_name_off,
                            int64_t* net_name_len) {
    Reader r{buf, n};
    int64_t idx = 0;
    if (net_name_off) *net_name_off = -1;
    if (net_name_len) *net_name_len = 0;
    uint32_t f, wt;
    while (r.tag(&f, &wt)) {
        int64_t off = 0, len = 0;
        if (f == 1 && wt == 2) {
            if (!r.value(wt, &off, &len)) return -1;
            if (net_name_off) *net_name_off = off;
            if (net_name_len) *net_name_len = len;
        } else if ((f == 100 || f == 2) && wt == 2) {
            if (!r.value(wt, &off, &len)) return -1;
            Reader sub{r.p, off + len};
            sub.pos = off;
            if (!parse_layer(sub, 0, f == 2, out, cap, &idx)) return -1;
        } else if (!r.value(wt, nullptr, nullptr)) {
            return -1;
        }
    }
    if (!r.ok) return -1;
    return idx;
}

}  // extern "C"
