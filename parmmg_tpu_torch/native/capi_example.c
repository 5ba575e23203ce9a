/* A foreign caller of the port's C ABI (`parmmg_capi.c`): stages a mesh
 * from raw buffers, adapts it, reads the result back, then adapts a
 * Medit file in one call.
 *
 *   capi_example DIR NP NE NT HSIZ HGRAD NITER INMESH OUTMESH
 *
 * reads DIR/verts.f64 (NP x 3 doubles), DIR/tets.i32 (NE x 4 ints,
 * 1-based), DIR/trias.i32 (NT x 3 ints, 1-based) and DIR/trrefs.i32 (NT
 * ints); runs pmmgtpu_init / set_* / run / get_* with -hsiz HSIZ,
 * -hgrad HGRAD and -niter NITER; writes DIR/out_sizes.i32 (np, ne, nt),
 * out_verts.f64, out_vrefs.i32, out_tets.i32 (1-based), out_trefs.i32,
 * out_trias.i32 (1-based), out_trrefs.i32 and out_met.f64 (iso); then
 * pmmgtpu_adapt_file(INMESH, "", OUTMESH, HSIZ, NITER, 1). Exits 0 when
 * every call returned 0.
 *
 * Build (the shim's path from parmmg_tpu_torch.native.capi_library()):
 *   gcc -O2 -o capi_example capi_example.c /path/to/libparmmg_capi-*.so
 * Run with the repository root (and the site packages that hold torch)
 * on PYTHONPATH.
 */

#include <stdio.h>
#include <stdlib.h>

/* parmmg_tpu_torch.api.Param */
enum { IPARAM_niter = 22, DPARAM_hsiz = 35, DPARAM_hgrad = 37 };

void *pmmgtpu_init(int nparts);
int pmmgtpu_free(void *h);
int pmmgtpu_set_vertices(void *h, const double *coords, const int *refs,
                         int np);
int pmmgtpu_set_tetrahedra(void *h, const int *tets, const int *refs,
                           int ne);
int pmmgtpu_set_triangles(void *h, const int *trias, const int *refs,
                          int nt);
int pmmgtpu_set_iparameter(void *h, int param, int value);
int pmmgtpu_set_dparameter(void *h, int param, double value);
int pmmgtpu_run(void *h);
int pmmgtpu_get_meshsize(void *h, int *np, int *ne, int *nt);
int pmmgtpu_get_vertices(void *h, double *coords, int *refs, int np);
int pmmgtpu_get_tetrahedra(void *h, int *tets, int *refs, int ne);
int pmmgtpu_get_triangles(void *h, int *trias, int *refs, int nt);
int pmmgtpu_get_metric(void *h, double *met, int np, int ncomp);
int pmmgtpu_adapt_file(const char *inmesh, const char *insol,
                       const char *outmesh, double hsiz, int niter,
                       int nparts);
const char *pmmgtpu_version(void);

static const char *dir;

static void *slurp(const char *name, size_t bytes) {
    char path[4096];
    void *buf = malloc(bytes ? bytes : 1);
    FILE *f;
    snprintf(path, sizeof path, "%s/%s", dir, name);
    f = fopen(path, "rb");
    if (!f || fread(buf, 1, bytes, f) != bytes) {
        fprintf(stderr, "capi_example: cannot read %s\n", path);
        exit(3);
    }
    fclose(f);
    return buf;
}

static void spill(const char *name, const void *buf, size_t bytes) {
    char path[4096];
    FILE *f;
    snprintf(path, sizeof path, "%s/%s", dir, name);
    f = fopen(path, "wb");
    if (!f || fwrite(buf, 1, bytes, f) != bytes) {
        fprintf(stderr, "capi_example: cannot write %s\n", path);
        exit(3);
    }
    fclose(f);
}

#define CHECK(call)                                                     \
    do {                                                                \
        int rc_ = (call);                                               \
        if (rc_ != 0) {                                                 \
            fprintf(stderr, "capi_example: %s returned %d\n", #call,   \
                    rc_);                                               \
            return 1;                                                   \
        }                                                               \
    } while (0)

int main(int argc, char **argv) {
    int np, ne, nt, sizes[3];
    double hsiz, hgrad, *verts, *vout, *met;
    int niter, *tets, *trias, *trrefs, *vref, *tout, *tref, *trout,
        *trref;
    void *h;

    if (argc != 10) {
        fprintf(stderr, "usage: capi_example DIR NP NE NT HSIZ HGRAD "
                        "NITER INMESH OUTMESH\n");
        return 2;
    }
    dir = argv[1];
    np = atoi(argv[2]);
    ne = atoi(argv[3]);
    nt = atoi(argv[4]);
    hsiz = atof(argv[5]);
    hgrad = atof(argv[6]);
    niter = atoi(argv[7]);
    verts = slurp("verts.f64", sizeof(double) * 3u * (size_t)np);
    tets = slurp("tets.i32", sizeof(int) * 4u * (size_t)ne);
    trias = slurp("trias.i32", sizeof(int) * 3u * (size_t)nt);
    trrefs = slurp("trrefs.i32", sizeof(int) * (size_t)nt);

    printf("capi_example: %s\n", pmmgtpu_version());
    h = pmmgtpu_init(1);
    if (!h) {
        fprintf(stderr, "capi_example: pmmgtpu_init failed\n");
        return 1;
    }
    CHECK(pmmgtpu_set_vertices(h, verts, NULL, np));
    CHECK(pmmgtpu_set_tetrahedra(h, tets, NULL, ne));
    CHECK(pmmgtpu_set_triangles(h, trias, trrefs, nt));
    CHECK(pmmgtpu_set_dparameter(h, DPARAM_hsiz, hsiz));
    CHECK(pmmgtpu_set_dparameter(h, DPARAM_hgrad, hgrad));
    CHECK(pmmgtpu_set_iparameter(h, IPARAM_niter, niter));
    CHECK(pmmgtpu_run(h));
    CHECK(pmmgtpu_get_meshsize(h, &sizes[0], &sizes[1], &sizes[2]));
    vout = malloc(sizeof(double) * 3u * (size_t)sizes[0]);
    vref = malloc(sizeof(int) * (size_t)sizes[0]);
    met = malloc(sizeof(double) * (size_t)sizes[0]);
    tout = malloc(sizeof(int) * 4u * (size_t)sizes[1]);
    tref = malloc(sizeof(int) * (size_t)sizes[1]);
    trout = malloc(sizeof(int) * 3u * (size_t)sizes[2]);
    trref = malloc(sizeof(int) * (size_t)sizes[2]);
    CHECK(pmmgtpu_get_vertices(h, vout, vref, sizes[0]));
    CHECK(pmmgtpu_get_tetrahedra(h, tout, tref, sizes[1]));
    CHECK(pmmgtpu_get_triangles(h, trout, trref, sizes[2]));
    CHECK(pmmgtpu_get_metric(h, met, sizes[0], 1));
    CHECK(pmmgtpu_free(h));
    spill("out_sizes.i32", sizes, sizeof sizes);
    spill("out_verts.f64", vout, sizeof(double) * 3u * (size_t)sizes[0]);
    spill("out_vrefs.i32", vref, sizeof(int) * (size_t)sizes[0]);
    spill("out_met.f64", met, sizeof(double) * (size_t)sizes[0]);
    spill("out_tets.i32", tout, sizeof(int) * 4u * (size_t)sizes[1]);
    spill("out_trefs.i32", tref, sizeof(int) * (size_t)sizes[1]);
    spill("out_trias.i32", trout, sizeof(int) * 3u * (size_t)sizes[2]);
    spill("out_trrefs.i32", trref, sizeof(int) * (size_t)sizes[2]);
    printf("capi_example: staged run np %d ne %d nt %d\n", sizes[0],
           sizes[1], sizes[2]);

    CHECK(pmmgtpu_adapt_file(argv[8], "", argv[9], hsiz, niter, 1));
    printf("capi_example: adapt_file wrote %s\n", argv[9]);
    fflush(stdout);
    return 0;
}
