/* A host program that drives the port's dycore through the generated
 * geos_tpufv3 bridge (interop/def_dycore.json) as a Fortran program would:
 * every array column-major with the face index last (interop/dycore.py),
 * passed with its dims reversed, as the generated Fortran wrappers pass
 * them (size(a, rank), ..., size(a, 1)).
 *
 *   dycore_host run BRIDGE_DIR DATA_DIR NPX NPZ NQ STEPS DT PTOP
 *     reads DATA_DIR/in_<field>.bin (the 14 DycoreState fields) and ak.bin,
 *     bk.bin; calls bridge_init, init, STEPS x run (each timed),
 *     validate_run on an equal and on a changed copy of u (must give 0
 *     and 1) and finalize; checks that the 10 arrays the port's state does
 *     not carry came back untouched; writes DATA_DIR/out_<field>.bin.
 *   dycore_host stamp BRIDGE_DIR NPX NPZ NQ
 *     fills every array from its Fortran indices (interop/dycore.py:stamp),
 *     calls run once (the hook checks the layout and writes the negated
 *     stamp into the 14 state fields) and checks what came back.
 *
 * Prints one "run <i>: <ms> ms" line per run and "HOST_OK" at the end;
 * exits non-zero on any failure.
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include "geos_tpufv3_bridge.h"

typedef struct {
    const char* name;
    int rank;
    int d[5];      /* Fortran dims, first index first */
    long n;
    float* a;
} Field;

enum { U, V, W, DELZ, PT, DELP, Q, PS, PE, PK, PELN, PKZ, PHIS, Q_CON, OMGA,
       UA, VA, UC, VC, MFX, MFY, CX, CY, DISS_EST, NFIELDS };

/* the 14 fields the port's state carries (interop/dycore.py:STATE_FIELDS) */
static const int kState[] = {U, V, W, DELZ, PT, DELP, Q, PS, PHIS, OMGA, UA,
                             VA, MFX, MFY};
enum { NSTATE = sizeof(kState) / sizeof(kState[0]) };

static Field F[NFIELDS];

static void def(int id, const char* name, int rank, int d0, int d1, int d2,
                int d3, int d4) {
    Field* f = &F[id];
    f->name = name;
    f->rank = rank;
    f->d[0] = d0; f->d[1] = d1; f->d[2] = d2; f->d[3] = d3; f->d[4] = d4;
    f->n = 1;
    for (int r = 0; r < rank; ++r) f->n *= f->d[r];
    f->a = (float*)malloc(sizeof(float) * f->n);
}

static void define_fields(int n, int K, int nq) {
    def(U, "u", 4, n, n + 1, K, 6, 0);
    def(V, "v", 4, n + 1, n, K, 6, 0);
    def(W, "w", 4, n, n, K, 6, 0);
    def(DELZ, "delz", 4, n, n, K, 6, 0);
    def(PT, "pt", 4, n, n, K, 6, 0);
    def(DELP, "delp", 4, n, n, K, 6, 0);
    def(Q, "q", 5, n, n, K, nq, 6);
    def(PS, "ps", 3, n, n, 6, 0, 0);
    def(PE, "pe", 4, n, n, K + 1, 6, 0);
    def(PK, "pk", 4, n, n, K + 1, 6, 0);
    def(PELN, "peln", 4, n, n, K + 1, 6, 0);
    def(PKZ, "pkz", 4, n, n, K, 6, 0);
    def(PHIS, "phis", 3, n, n, 6, 0, 0);
    def(Q_CON, "q_con", 4, n, n, K, 6, 0);
    def(OMGA, "omga", 4, n, n, K, 6, 0);
    def(UA, "ua", 4, n, n, K, 6, 0);
    def(VA, "va", 4, n, n, K, 6, 0);
    def(UC, "uc", 4, n + 1, n, K, 6, 0);
    def(VC, "vc", 4, n, n + 1, K, 6, 0);
    def(MFX, "mfx", 4, n + 1, n, K, 6, 0);
    def(MFY, "mfy", 4, n, n + 1, K, 6, 0);
    def(CX, "cx", 4, n + 1, n, K, 6, 0);
    def(CY, "cy", 4, n, n + 1, K, 6, 0);
    def(DISS_EST, "diss_est", 4, n, n, K, 6, 0);
}

/* the stamp of Fortran element (i, j, k, t, face), 1-based; k and t are 0
 * where the rank has none */
static float stamp_of(const Field* f, long e) {
    int idx[5] = {0, 0, 0, 0, 0};
    for (int r = 0; r < f->rank; ++r) {
        idx[r] = (int)(e % f->d[r]) + 1;
        e /= f->d[r];
    }
    int i = idx[0], j = idx[1], k = 0, t = 0, face;
    if (f->rank == 3) {
        face = idx[2];
    } else if (f->rank == 4) {
        k = idx[2];
        face = idx[3];
    } else {
        k = idx[2];
        t = idx[3];
        face = idx[4];
    }
    return (float)(i + 16 * (j + 16 * (k + 16 * (t + 4 * face))));
}

static int io(const char* dir, const char* prefix, const char* name,
              float* a, long n, int write) {
    char path[4096];
    snprintf(path, sizeof path, "%s/%s%s.bin", dir, prefix, name);
    FILE* fp = fopen(path, write ? "wb" : "rb");
    if (!fp) {
        fprintf(stderr, "cannot open %s\n", path);
        return 1;
    }
    size_t got = write ? fwrite(a, sizeof(float), n, fp)
                       : fread(a, sizeof(float), n, fp);
    fclose(fp);
    if (got != (size_t)n) {
        fprintf(stderr, "%s: %zu of %ld floats\n", path, got, n);
        return 1;
    }
    return 0;
}

/* an array argument: the pointer, then the dims reversed */
#define A3(x) F[x].a, F[x].d[2], F[x].d[1], F[x].d[0]
#define A4(x) F[x].a, F[x].d[3], F[x].d[2], F[x].d[1], F[x].d[0]
#define A5(x) F[x].a, F[x].d[4], F[x].d[3], F[x].d[2], F[x].d[1], F[x].d[0]

static int run_once(int n, int K, float dt, float ptop, float* ak, float* bk,
                    double* ms) {
    struct timespec t0, t1;
    clock_gettime(CLOCK_MONOTONIC, &t0);
    int rc = geos_tpufv3_run(
        0, n, n, K, 6, dt, ptop, 0, 0, ak, K + 1, bk, K + 1,
        A4(U), A4(V), A4(W), A4(DELZ), A4(PT), A4(DELP), A5(Q), A3(PS),
        A4(PE), A4(PK), A4(PELN), A4(PKZ), A3(PHIS), A4(Q_CON), A4(OMGA),
        A4(UA), A4(VA), A4(UC), A4(VC), A4(MFX), A4(MFY), A4(CX), A4(CY),
        A4(DISS_EST));
    clock_gettime(CLOCK_MONOTONIC, &t1);
    *ms = (t1.tv_sec - t0.tv_sec) * 1e3 + (t1.tv_nsec - t0.tv_nsec) * 1e-6;
    return rc;
}

static int is_state(int id) {
    for (int s = 0; s < NSTATE; ++s)
        if (kState[s] == id) return 1;
    return 0;
}

static int init_bridge(const char* bridge_dir, int n, int K, int nq,
                       float dt) {
    if (geos_tpufv3_bridge_init(bridge_dir)) {
        fprintf(stderr, "bridge_init failed\n");
        return 1;
    }
    if (geos_tpufv3_init(0, n, n, K, 6, 1, n, 1, n, -2, n + 3, -2, n + 3, dt,
                         nq)) {
        fprintf(stderr, "init failed\n");
        return 1;
    }
    return 0;
}

static int mode_run(const char* bridge_dir, const char* data, int n, int K,
                    int nq, int steps, float dt, float ptop) {
    define_fields(n, K, nq);
    float* ak = (float*)malloc(sizeof(float) * (K + 1));
    float* bk = (float*)malloc(sizeof(float) * (K + 1));
    if (io(data, "", "ak", ak, K + 1, 0) || io(data, "", "bk", bk, K + 1, 0))
        return 20;
    for (int id = 0; id < NFIELDS; ++id) {
        if (is_state(id)) {
            if (io(data, "in_", F[id].name, F[id].a, F[id].n, 0)) return 21;
        } else {
            for (long e = 0; e < F[id].n; ++e) F[id].a[e] = -1234.5f;
        }
    }
    if (init_bridge(bridge_dir, n, K, nq, dt)) return 22;
    for (int s = 0; s < steps; ++s) {
        double ms;
        if (run_once(n, K, dt, ptop, ak, bk, &ms)) {
            fprintf(stderr, "run %d failed\n", s + 1);
            return 23;
        }
        printf("run %d: %.3f ms\n", s + 1, ms);
        fflush(stdout);
    }
    /* the dual-execution comparator on u: an equal copy passes, a copy
     * with one element changed fails */
    long nu = F[U].n;
    double* ref = (double*)malloc(sizeof(double) * nu);
    double* test = (double*)malloc(sizeof(double) * nu);
    for (long e = 0; e < nu; ++e) ref[e] = test[e] = F[U].a[e];
    int same = geos_tpufv3_validate_run(ref, test, (int)nu, 1e-12);
    test[nu / 2] += 1.0;
    int changed = geos_tpufv3_validate_run(ref, test, (int)nu, 1e-12);
    printf("validate_run: equal copy %d, changed copy %d\n", same, changed);
    if (same != 0 || changed != 1) return 24;
    if (geos_tpufv3_finalize()) return 25;
    geos_tpufv3_bridge_finalize();
    for (int id = 0; id < NFIELDS; ++id) {
        if (is_state(id)) {
            if (io(data, "out_", F[id].name, F[id].a, F[id].n, 1)) return 26;
            continue;
        }
        for (long e = 0; e < F[id].n; ++e) {
            if (F[id].a[e] != -1234.5f) {
                fprintf(stderr, "%s changed at %ld\n", F[id].name, e);
                return 27;
            }
        }
    }
    printf("HOST_OK\n");
    return 0;
}

static int mode_stamp(const char* bridge_dir, int n, int K, int nq) {
    if (n + 1 >= 16 || K + 1 >= 16 || nq >= 4) {
        fprintf(stderr, "stamp: needs npx, npz < 15 and nq < 4\n");
        return 30;
    }
    define_fields(n, K, nq);
    float* ak = (float*)calloc(K + 1, sizeof(float));
    float* bk = (float*)calloc(K + 1, sizeof(float));
    for (int id = 0; id < NFIELDS; ++id)
        for (long e = 0; e < F[id].n; ++e) F[id].a[e] = stamp_of(&F[id], e);
    if (init_bridge(bridge_dir, n, K, nq, 1.0f)) return 31;
    double ms;
    if (run_once(n, K, 1.0f, 1.0f, ak, bk, &ms)) {
        fprintf(stderr, "run failed: the hook found a field off its "
                        "Fortran indices\n");
        return 32;
    }
    printf("run 1: %.3f ms\n", ms);
    if (geos_tpufv3_finalize()) return 33;
    geos_tpufv3_bridge_finalize();
    for (int id = 0; id < NFIELDS; ++id) {
        float sign = is_state(id) ? -1.0f : 1.0f;
        for (long e = 0; e < F[id].n; ++e) {
            if (F[id].a[e] != sign * stamp_of(&F[id], e)) {
                fprintf(stderr, "%s: element %ld came back %g, not %g\n",
                        F[id].name, e, F[id].a[e],
                        sign * stamp_of(&F[id], e));
                return 34;
            }
        }
    }
    printf("HOST_OK\n");
    return 0;
}

int main(int argc, char** argv) {
    if (argc == 10 && strcmp(argv[1], "run") == 0)
        return mode_run(argv[2], argv[3], atoi(argv[4]), atoi(argv[5]),
                        atoi(argv[6]), atoi(argv[7]), (float)atof(argv[8]),
                        (float)atof(argv[9]));
    if (argc == 6 && strcmp(argv[1], "stamp") == 0)
        return mode_stamp(argv[2], atoi(argv[3]), atoi(argv[4]),
                          atoi(argv[5]));
    fprintf(stderr,
            "usage: %s run BRIDGE_DIR DATA_DIR NPX NPZ NQ STEPS DT PTOP\n"
            "       %s stamp BRIDGE_DIR NPX NPZ NQ\n", argv[0], argv[0]);
    return 2;
}
